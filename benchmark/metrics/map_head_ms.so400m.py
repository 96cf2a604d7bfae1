"""The host's ms a batch in SigLIP's attention-pooling head: the mean of the
window's ``tower.map_head`` spans (``clipx_torch/models/clip.py``).

The head only enqueues work (about 0.1 ms of its own host time), but with
two batches in flight the launch queue is full when the host reaches it, so
each of its launches waits for a kernel ahead of it to finish: the reading
is the head's enqueue time under that backpressure, its launches times the
mean device time of the kernels they wait on (about 12 ms at batch 128 on an
H100). A wait for the card inside the head (a host sync) lifts it to the
device time of all the work in flight, one to two batches (350 to 700 ms
there). None for a program without the span."""

from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "tower.map_head")
