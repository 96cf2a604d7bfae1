"""The host's ms to stage one batch: the mean of the program's
``encoder.stage`` spans in the window (``Encoder.encode_images_async`` up
to the pinned copy of the frames and the pinned result buffer)."""

from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "encoder.stage")
