#!/bin/sh
# CI entry point: full test suite on a virtual 8-device CPU mesh
# (conftest.py forces JAX_PLATFORMS=cpu + x64), then the library-API
# examples as smoke tests.
set -e
cd "$(dirname "$0")/.."
python -m pytest tests/ -q
JAX_PLATFORMS=cpu python examples/bulk_demo.py
JAX_PLATFORMS=cpu python examples/clones_demo.py
JAX_PLATFORMS=cpu LP_VARS=400 LP_CELLS=600 LP_DONORS=3 LP_INIT=4 \
    python examples/large_pool_demo.py
