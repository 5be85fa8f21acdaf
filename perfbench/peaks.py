"""Published peaks of the chips the benchmark runs on (NVIDIA's data sheet
for the H100 SXM part: dense rates without sparsity, at the full 700 W
power limit).  A share of a roofline or of a peak is stated against these,
with the card's power limit written beside it."""

H100_SXM = {
    "bf16_flops": 989e12,     # tensor cores, bfloat16 and float16, dense
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,      # CUDA cores
    "hbm_bytes": 3.35e12,     # HBM3, bytes a second
    "hbm_capacity": 80e9,
}


def peaks_for(device_name: str) -> dict:
    """The table of the card named ``device_name``; only the H100 is known."""
    if "H100" not in device_name:
        raise ValueError(f"no table of peaks for {device_name!r}")
    return H100_SXM
