"""K2' in the dense tail (``search/device_step.count_mask`` ->
``csrc/count_mask.cu``): its launches' summed bound (the rows their
locations touch read once, every other input and output once, at the HBM
rate) over their summed device time, CUDA events around each call."""

from harness.kernels import KernelLog, count_mask_bytes
from harness.trace import patched


def instrument(record):
    from kmcp_tpu_torch.search import device_step

    log = record.kernels.setdefault("count_mask", KernelLog())
    return patched(device_step, "count_mask", log.wrap(
        record.torch, device_step.count_mask, count_mask_bytes))


def read(record):
    log = record.kernels.get("count_mask")
    return log.roofline_pct(record.torch) if log else None
