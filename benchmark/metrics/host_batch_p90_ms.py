"""The streamer: the 90th percentile over the traced window's batches of
the time from a batch's first pull to the streamer reporting it drained,
on the host's clock (interpolated between ranks)."""

import numpy as np


def read(record):
    if not record.batch_ms:
        return None
    return float(np.percentile(record.batch_ms, 90))
