"""The least time a K3 launch could take on one H100, frozen from the
port's `workload.py` (`k3_bound_ms` and its G1 constants) so that a later
change to the port does not move the yardstick; `bounds.py` holds K1's and
the card's peaks.

A launch's least time is the larger of its bytes over the card's HBM
bandwidth and its Fq products' multiply-adds over the CUDA cores' rate
(`bounds.bound_ms`).  The launch records (`kernels.record` entries of form
"k3_<form>", written by the port's `curve/g1.py`) carry what the host
knows at the launch; what it does not is set here:
  * "add" and "normalize": every lane a generic one (no lane at
    infinity), as on the Dory path (Gamma1's folds, the row sums);
  * "scalar_mul": half of each lane's `bits` set, the mean for uniform
    scalars (Fiat-Shamir challenges: Dory's folds);
  * "bucket_sum": the whole sum's work on its first level's launch (its
    key), none on the later levels' (key None): their partials are the
    kernel's own, as the port's bound counts them.
"""

from __future__ import annotations

from typing import Tuple

from .bounds import bound_ms

# one Jacobian point's bytes (X, Y, Z) and one affine base's (X, Y)
G1_POINT_BYTES = 96
G1_AFFINE_BYTES = 64
# Fq products of each point formula (an Fq product is
# `bounds.MADS_PER_PRODUCT` multiply-adds, as Fr's)
G1_ADD_PRODUCTS = 16          # add-2007-bl, 11M + 5S
G1_MADD_PRODUCTS = 11         # madd-2007-bl, 7M + 4S
G1_DOUBLE_PRODUCTS = 7        # dbl-2009-l, 2M + 5S
# Z^(q-2): 253 squarings and 109 products, then Z^-2, Z^-3, X Z^-2, Y Z^-3
G1_NORMALIZE_PRODUCTS = 253 + 109 + 4

FORMS = ("add", "double", "scalar_mul", "normalize", "bucket_sum",
         "bucket_reduce")


def _bound(form: str, lanes: int, generic_adds: int = None, bits: int = 0,
           set_bits: int = 0, words: int = 8, entries: int = 0,
           segments: int = 0, n_seg: int = 0, c: int = 0
           ) -> Tuple[float, str]:
    """The port's `workload.k3_bound_ms`, as it was at commit d1e1e0b."""
    if form == "add":
        n_bytes = 3 * G1_POINT_BYTES * lanes
        products = G1_ADD_PRODUCTS * (lanes if generic_adds is None
                                      else generic_adds)
    elif form == "double":
        n_bytes = 2 * G1_POINT_BYTES * lanes
        products = G1_DOUBLE_PRODUCTS * lanes
    elif form == "scalar_mul":
        n_bytes = (2 * G1_POINT_BYTES + 4 * words) * lanes
        products = G1_DOUBLE_PRODUCTS * bits * lanes \
            + G1_ADD_PRODUCTS * set_bits
    elif form == "normalize":
        n_bytes = 2 * G1_POINT_BYTES * lanes
        products = G1_NORMALIZE_PRODUCTS * (lanes if generic_adds is None
                                            else generic_adds)
    elif form == "bucket_sum":
        n_bytes = G1_AFFINE_BYTES * lanes + 4 * entries \
            + (16 + G1_POINT_BYTES) * n_seg
        products = G1_MADD_PRODUCTS * (entries - segments)
    elif form == "bucket_reduce":
        n_bytes = G1_POINT_BYTES * ((lanes << c) + 1)
        products = G1_ADD_PRODUCTS * (2 * (lanes << c) + lanes) \
            + G1_DOUBLE_PRODUCTS * c * (lanes - 1)
    else:
        raise ValueError(f"K3 has no form {form!r}")
    return bound_ms(n_bytes, products)


def k3_bound_ms(form: str, key) -> Tuple[float, str]:
    """One K3 launch of `form` (without the record's "k3_" prefix) with
    its record `key`: (lanes,) for "add", "double", "normalize"; (lanes,
    bits, words) for "scalar_mul"; (bases, entries, non-empty segments,
    segments) for a bucket sum's first level, None for a later level;
    (windows, c) for "bucket_reduce"."""
    if form not in FORMS:
        raise ValueError(f"K3 has no form {form!r}")
    if key is None:
        if form != "bucket_sum":
            raise ValueError(f"K3 {form}: a launch record without sizes")
        return 0.0, "none"
    if form in ("add", "double", "normalize"):
        (lanes,) = key
        return _bound(form, lanes)
    if form == "scalar_mul":
        lanes, bits, words = key
        return _bound(form, lanes, bits=bits, set_bits=lanes * bits // 2,
                      words=words)
    if form == "bucket_sum":
        lanes, entries, segments, n_seg = key
        return _bound(form, lanes, entries=entries, segments=segments,
                      n_seg=n_seg)
    windows, c = key
    return _bound(form, windows, c=c)
