"""The flash attention forward's share of its H100 roofline in the traced
groups: the least time of the self-attention calls that the flash gate
takes (N >= 512, N and the keys a multiple of 128, head size 64 or 128), on
the CFG-doubled rows of every UNet eval, over the device time of the
kernels named flash_fwd."""

from benchmark.modules import counts

PATTERNS = ("flash_fwd",)


def read(r):
    if r.trace is None:
        return None
    seconds = r.trace.device_seconds(PATTERNS)
    if seconds <= 0:
        return None
    cfg = r.cell.config
    flops = counts(cfg)
    net = cfg["graph"]["network_config"]["params"]
    lat = cfg["image_size"] // 8
    rows = 2 * max(cfg["serving"]["buckets"])
    evals = r.traced_units * (2 * cfg["sampler"]["noise_iters"] + cfg["sampler"]["num_steps"])
    d = net["num_head_channels"]
    work = [flops.flash_fwd_work(rows, c // d, n, d) for n, c, _ in flops.attn_layers(net, lat, lat)
            if n >= 512 and n % 128 == 0 and d in (64, 128)]
    least = flops.least_seconds(evals * sum(w[0] for w in work), evals * sum(w[1] for w in work))
    return 100.0 * least / seconds
