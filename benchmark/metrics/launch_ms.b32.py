"""The host's ms to launch one batch: the mean of the program's
``encoder.launch`` spans in the window (``Encoder.encode_images_async``'s
copy to the card, the tower's launches, the copy back and the event)."""

from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "encoder.launch")
