"""Host-side ID/donor matching utilities.

These are tiny O(K^2) / O(n log n) host operations (donor alignment,
label matching); they orchestrate device kernels but never run on the
device.
Functional equivalents of vireo_base.py:130-254 and base_utils.py:3-31,
implemented with vectorized numpy rather than the reference's loops.
"""

import numpy as np
from scipy.optimize import linear_sum_assignment

__all__ = ["match", "optimal_match", "greed_match", "donor_select",
           "get_confusion"]


def match(ref_ids, new_ids, uniq_ref_only=True):
    """Index of each ref_id within new_ids; None where missing.

    Same contract as the reference `match` (vireo_base.py:130-184):
    ``new_ids[result[i]] == ref_ids[i]`` where found. When
    `uniq_ref_only` is True, duplicated ref values match only once (the
    first occurrence in sorted order); later duplicates map to None.
    """
    ref = np.asarray(ref_ids)
    new = np.asarray(new_ids)
    order_new = np.argsort(new, kind="stable")
    new_sorted = new[order_new]

    pos = np.searchsorted(new_sorted, ref, side="left")
    pos_clip = np.minimum(pos, len(new_sorted) - 1) if len(new_sorted) else pos
    found = np.zeros(len(ref), dtype=bool)
    if len(new_sorted):
        found = new_sorted[pos_clip] == ref

    out = np.empty(len(ref), dtype=object)
    out[:] = None
    idx_found = np.where(found)[0]
    out[idx_found] = order_new[pos_clip[idx_found]]

    if uniq_ref_only and len(idx_found) > 0:
        # among ref entries matching the same new id, keep only the one
        # that comes first in ref-sorted order
        order_ref = np.argsort(ref, kind="stable")
        seen = set()
        for i in order_ref:
            if out[i] is None:
                continue
            v = ref[i]
            if v in seen:
                out[i] = None
            else:
                seen.add(v)
    return out


def optimal_match(X, Z, axis=1, return_delta=False):
    """Hungarian alignment of slices of Z to slices of X along `axis`.

    Cost is mean absolute difference, as in the reference
    (vireo_base.py:187-206). Returns (idx0, idx1[, diff_mat]).
    """
    X = np.asarray(X)
    Z = np.asarray(Z)
    Xm = np.moveaxis(X, axis, 0).reshape(X.shape[axis], -1)
    Zm = np.moveaxis(Z, axis, 0).reshape(Z.shape[axis], -1)
    diff_mat = np.abs(Xm[:, None, :] - Zm[None, :, :]).mean(axis=2)
    idx0, idx1 = linear_sum_assignment(diff_mat)
    if return_delta:
        return idx0, idx1, diff_mat
    return idx0, idx1


def greed_match(X, Z, axis=1):
    """Deprecated upstream (vireo_base.py:209-215); kept only for API
    completeness. Use `optimal_match`."""
    print("This method has been dispatched, please use optimal_match!")
    return optimal_match(X, Z, axis=axis)[1]


def donor_select(GT_prob, ID_prob, n_donor, mode="distance", verbose=True):
    """Pick n_donor donors out of an over-clustered fit.

    mode="size": largest cell counts. mode="distance": greedy max-min
    genotype distance starting from the largest donor, replicating
    vireo_base.py:217-254.
    """
    GT_prob = np.asarray(GT_prob)
    ID_prob = np.asarray(ID_prob)
    donor_cnt = np.sum(ID_prob, axis=0)
    K = GT_prob.shape[1]

    if mode == "size":
        donor_idx = list(np.argsort(donor_cnt)[::-1])
    else:
        flat = np.swapaxes(GT_prob, 0, 1).reshape(K, -1)
        GT_diff = np.abs(flat[:, None, :] - flat[None, :, :]).mean(axis=2)

        donor_idx = [int(np.argmax(donor_cnt))]
        donor_left = np.delete(np.arange(K), donor_idx)
        GT_diff = np.delete(GT_diff, donor_idx, axis=1)
        while len(donor_idx) < GT_diff.shape[0]:
            _idx = int(np.argmax(np.min(GT_diff[donor_idx, :], axis=0)))
            donor_idx.append(int(donor_left[_idx]))
            donor_left = np.delete(donor_left, _idx)
            GT_diff = np.delete(GT_diff, _idx, axis=1)

    if verbose:
        print("[vireo] donor size with searching extra %d donors:"
              % (K - n_donor))
        print("\t".join(["donor%d" % x for x in donor_idx]))
        print("\t".join(["%.0f" % donor_cnt[x] for x in donor_idx]))

    ID_prob_out = ID_prob[:, donor_idx[:n_donor]].copy()
    ID_prob_out[ID_prob_out < 1e-10] = 1e-10
    return ID_prob_out


def get_confusion(ids1, ids2):
    """Confusion matrix between two label vectors (base_utils.py:3-31)."""
    ids1 = np.asarray(ids1)
    ids2 = np.asarray(ids2)
    ids1_uniq = np.unique(ids1)
    ids2_uniq = np.unique(ids2)
    code1 = np.searchsorted(ids1_uniq, ids1)
    code2 = np.searchsorted(ids2_uniq, ids2)
    confuse_mat = np.zeros((len(ids1_uniq), len(ids2_uniq)), dtype=int)
    np.add.at(confuse_mat, (code1, code2), 1)
    return confuse_mat, ids1_uniq, ids2_uniq
