"""The streamer: queries (reads, or pairs) completed in the traced window
over its wall, on the host's clock.  The host's one Python thread sets
this rate, and its speed moves between runs on a shared host by more
than an end-to-end bound may hold, so it is read here, per layer."""


def read(record):
    if record.queries <= 0 or record.window_s <= 0:
        return None
    return record.queries / record.window_s
