"""The chip's published peaks, against which every share is stated.

NVIDIA H100 SXM (80 GB HBM3) data sheet, dense rates at the 700 W limit:
3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the tensor cores (the
port pins TF32 off for its matrix products, ``models/gcn.py``).
"""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def roofline_share(nbytes: float, flops: float, seconds: float):
    """Percent of the roofline: the least time the chip could take (the
    larger of bytes over the HBM rate and operations over the float32
    rate) over ``seconds``; None when nothing was timed."""
    if seconds <= 0:
        return None
    least = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
    return 100.0 * least / seconds
