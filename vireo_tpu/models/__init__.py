from . import vireo
from . import doublet
from . import bmm
from . import bulk
from . import ambient
from . import variant_select
