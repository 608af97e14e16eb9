"""Operations and bytes of K1, the port's ``xcorr_fold`` kernel
(``csrc/xcorr_fold.cu``: the PSS scan and its incoherent fold over a stack
of captures).

Operations: per capture, 3 PSS templates x n_hyp hypotheses x 9,600 lags
x n_comb folds x 137 complex multiply-adds of 8 real flops each; every
float32 product costs three TF32 products (3xTF32, the least that keeps
float32 accuracy on the tensor cores). Bytes: the capture stack read once
(two float32 planes) and the folded output written once (3 x 9,600 x
n_hyp float32 per capture). What the kernel does beyond this (its groups'
fold-start spread, a padded group's zero templates, the template bank's
reads) is not counted.
"""

from benchmark.peaks import PEAK_TF32_FLOPS, bound_s

KERNEL = "xcorr_fold_tc_kernel"


def flops(b: int, n_hyp: int, n_comb: int) -> float:
    return 3.0 * 3 * n_hyp * 9600 * n_comb * 137 * 8 * b


def nbytes(b: int, n_hyp: int, n_cap: int) -> float:
    return 4.0 * b * (2 * n_cap + 3 * 9600 * n_hyp)


def bound(b: int, n_hyp: int, n_comb: int, n_cap: int) -> float:
    """Seconds one launch over ``b`` captures needs at the least."""
    return bound_s(flops(b, n_hyp, n_comb), nbytes(b, n_hyp, n_cap),
                   PEAK_TF32_FLOPS)
