"""SigLIP's image tower's share of the bf16 peak: its model FLOPs an image
(``counts_siglip.image_tower_flops``, from the configuration's shapes) times
the window's img/s, over 989 TFLOP/s, in %."""

from benchmark import counts, counts_siglip


def read(run):
    rate = run.e2e.get("index_img_per_s")
    if not rate:
        return None
    flops = counts_siglip.image_tower_flops(run.config["vision"])
    return 100.0 * flops * rate / counts.PEAK_BF16_FLOPS
