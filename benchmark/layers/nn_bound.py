"""The NN kernel's bound, copied from the port's ``ops/cuda/nn_kernel.py``
(``bound_ms``, ``io_ms``, ``candidate_ops``) so that the yardstick stays
where it is when the program moves, with the H100's published peaks. No
metric reads it yet: a roofline share of the kernel needs the valid
(src, dst) pairs of each launch, which the program does not count yet."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: 67 TFLOP/s of float32 outside the tensor
# cores counts an FMA as two operations; the kernel contracts none, so it
# does at most half that many lane-operations. 3.35 TB/s of HBM3.
FP32_LANE_OPS_PER_S = 33.5e12
HBM_BYTES_PER_S = 3.35e12

FORMS = ("expanded", "elementwise", "sentinel")


def candidate_ops(form: str, points: bool) -> int:
    """FP32 lane-operations one (src, dst) candidate needs: 8 for the
    distance in any form and one to fold it into the running minimum; the
    sentinel form's points output adds its tie compare."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    return 10 if form == "sentinel" and points else 9


def bound_ms(valid_pairs: float, form: str, points: bool) -> float:
    """Least milliseconds one H100 could take for a sweep over
    ``valid_pairs`` (src, dst) candidates at the peak FP32 rate (the
    bytes, :func:`io_ms`, take far less at every shape in use)."""
    return candidate_ops(form, points) * valid_pairs / FP32_LANE_OPS_PER_S * 1e3


def io_ms(b: int, n: int, m: int, points: bool, src_mask: bool = False) -> float:
    """Milliseconds to move one launch's bytes at the card's memory rate:
    src, dst and the masks read once, the outputs written once."""
    nbytes = b * (12 * n + 13 * m + (n if src_mask else 0)
                  + (12 if points else 4) * n + 4 * n)
    return nbytes / HBM_BYTES_PER_S * 1e3
