"""The flash attention backward's share of its H100 roofline in the traced
steps: the least time of the backward of each self-attention the flash gate
takes (N >= 512, N a multiple of 128, head size 64 or 128) after the first
trainable t_attn (before it nothing needs a gradient), on every
micro-batch, over the device time of the kernels named flash_bwd."""

from benchmark.modules import counts

PATTERNS = ("flash_bwd",)


def read(r):
    if r.trace is None:
        return None
    seconds = r.trace.device_seconds(PATTERNS)
    if seconds <= 0:
        return None
    cfg, mix = r.cell.config, r.cell.traffic
    flops = counts(cfg)
    net = cfg["graph"]["network_config"]["params"]
    lat = cfg["image_size"] // 8
    calls = r.traced_units * mix["accumulate"]
    d = net["num_head_channels"]
    work = [flops.flash_bwd_work(mix["micro_batch"], c // d, n, d)
            for n, c, _ in flops.attn_layers(net, lat, lat)[1:]
            if n >= 512 and n % 128 == 0 and d in (64, 128)]
    least = flops.least_seconds(calls * sum(w[0] for w in work), calls * sum(w[1] for w in work))
    return 100.0 * least / seconds
