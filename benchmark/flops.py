"""The yardstick's arithmetic: operations of the UDiffText networks counted
from their shapes, the work of the flash attention and GEGLU calls, and one
H100's peaks.

Operations are 2 per multiply-add of every matrix product, convolution and
attention product, every tap of a padded convolution included, and no
elementwise op: `torch.utils.flop_counter`'s rule, so that the UNet and
decoder counts tie to the program's own `flops_of` (benchmark/tests). The
peaks are NVIDIA's data sheet for the H100 SXM at 700 W, dense.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass
class Op:
    """One product: forward operations; in fine-tuning, whether its input
    needs a gradient (`dx`), whether its weight trains (`dw`), and the
    factor of its input gradient's operations to its forward's (`bwd`)."""

    flops: float
    dx: bool = False
    dw: bool = False
    bwd: float = 1.0


def conv(b, h_out, w_out, c_in, c_out, k) -> float:
    return 2.0 * b * h_out * w_out * c_in * c_out * k * k


def linear(m, k, n) -> float:
    return 2.0 * m * k * n


def attn(b, heads, nq, nk, d) -> float:
    """q·kᵀ and p·v."""
    return 4.0 * b * heads * nq * nk * d


def attn_layers(net: dict, h: int, w: int) -> List[Tuple[int, int, int]]:
    """(tokens, width, heads) of each UNet transformer layer, in order."""
    out: List[Tuple[int, int, int]] = []
    _walk(net, 1, h, w, 12, True, ("t_attn",), [], out)
    return out


def unet_ops(net: dict, b: int, h: int, w: int, ctx_len: int, with_kv: bool = True,
             trainable: Tuple[str, ...] = ("t_attn", "t_norm")) -> List[Op]:
    """The UNet's products on b rows of an h×w latent with a ctx_len-token
    context (with_kv: the context's K/V projections included). The gradient
    flags follow fine-tuning of the `trainable` branches: nothing before the
    first t_attn needs an input gradient, the time embedding's and the K/V
    projections' inputs never do, and an attention's input gradient takes
    two products for each of its forward's."""
    ops: List[Op] = []
    _walk(net, b, h, w, ctx_len, with_kv, trainable, ops, [])
    return ops


def _walk(net, b, h, w, ctx_len, with_kv, trainable, ops, layers) -> None:
    mc, mult = net["model_channels"], list(net["channel_mult"])
    hc, nrb = net["num_head_channels"], net["num_res_blocks"]
    attn_res, t_ctx, emb = set(net["attention_resolutions"]), net["t_context_dim"], 4 * mc
    t_trains = any("t_attn" in k for k in trainable)
    state = {"grad": False}

    def add(flops, dw=False, bwd=1.0, dx=None):
        ops.append(Op(flops, state["grad"] if dx is None else dx, dw, bwd))

    def resblock(c_in, c_out, hh, ww):
        add(conv(b, hh, ww, c_in, c_out, 3))
        add(linear(b, emb, c_out), dx=False)
        add(conv(b, hh, ww, c_out, c_out, 3))
        if c_in != c_out:
            add(conv(b, hh, ww, c_in, c_out, 1))

    def transformer(c, hh, ww):
        n, heads = hh * ww, c // hc
        layers.append((n, c, heads))
        add(linear(b * n, c, c))                        # proj_in
        for _ in range(3):
            add(linear(b * n, c, c))                    # attn1 q, k, v
        add(attn(b, heads, n, n, hc), bwd=2.0)
        add(linear(b * n, c, c))                        # attn1 out
        add(linear(b * n, c, c), dw=t_trains)           # t_attn q
        if with_kv:
            for _ in range(2):                          # t_attn k, v
                add(linear(b * ctx_len, t_ctx, c), dw=t_trains, dx=False)
        state["grad"] = state["grad"] or t_trains
        add(attn(b, heads, n, ctx_len, hc), bwd=2.0)
        add(linear(b * n, c, c), dw=t_trains)           # t_attn out
        add(linear(b * n, c, 8 * c))                    # GEGLU in
        add(linear(b * n, 4 * c, c))                    # GEGLU out
        add(linear(b * n, c, c))                        # proj_out

    add(linear(b, mc, emb), dx=False)
    add(linear(b, emb, emb), dx=False)
    add(conv(b, h, w, net["in_channels"], mc, 3))
    chans, ch, ds = [mc], mc, 1
    for level, m in enumerate(mult):
        for _ in range(nrb):
            resblock(ch, m * mc, h // ds, w // ds)
            ch = m * mc
            if ds in attn_res:
                transformer(ch, h // ds, w // ds)
            chans.append(ch)
        if level != len(mult) - 1:
            add(conv(b, h // ds // 2, w // ds // 2, ch, ch, 3))
            chans.append(ch)
            ds *= 2
    resblock(ch, ch, h // ds, w // ds)
    transformer(ch, h // ds, w // ds)
    resblock(ch, ch, h // ds, w // ds)
    for level, m in list(enumerate(mult))[::-1]:
        for i in range(nrb + 1):
            resblock(ch + chans.pop(), m * mc, h // ds, w // ds)
            ch = m * mc
            if ds in attn_res:
                transformer(ch, h // ds, w // ds)
            if level and i == nrb:
                ds //= 2
                add(conv(b, h // ds, w // ds, ch, ch, 3))
    add(conv(b, h, w, mc, net["out_channels"], 3))


def forward(ops: List[Op]) -> float:
    return sum(o.flops for o in ops)


def backward(ops: List[Op]) -> float:
    """Input gradients where needed, and the weight gradients of the
    trainable products (one product each, the forward's size)."""
    return sum(o.flops * o.bwd * o.dx + o.flops * o.dw for o in ops)


def _vae_res(b, hh, ww, c_in, c_out) -> float:
    f = conv(b, hh, ww, c_in, c_out, 3) + conv(b, hh, ww, c_out, c_out, 3)
    return f + (conv(b, hh, ww, c_in, c_out, 1) if c_in != c_out else 0.0)


def _vae_mid(b, hh, ww, c) -> float:
    n = hh * ww
    return 2 * _vae_res(b, hh, ww, c, c) + 4 * conv(b, hh, ww, c, c, 1) + attn(b, 1, n, n, c)


def vae_encode(dd: dict, embed_dim: int, b: int, h: int, w: int) -> float:
    """The encoder and quant_conv on b images of h×w."""
    ch, mult, nrb, z = dd["ch"], list(dd["ch_mult"]), dd["num_res_blocks"], dd["z_channels"]
    f = conv(b, h, w, dd["in_channels"], ch, 3)
    c, hh, ww = ch, h, w
    for i, m in enumerate(mult):
        for _ in range(nrb):
            f += _vae_res(b, hh, ww, c, ch * m)
            c = ch * m
        if i != len(mult) - 1:
            hh, ww = hh // 2, ww // 2
            f += conv(b, hh, ww, c, c, 3)
    f += _vae_mid(b, hh, ww, c) + conv(b, hh, ww, c, 2 * z, 3)
    return f + conv(b, hh, ww, 2 * z, 2 * embed_dim, 1)


def vae_decode(dd: dict, embed_dim: int, b: int, h: int, w: int) -> float:
    """post_quant_conv and the decoder on b latents of h×w."""
    ch, mult, nrb, z = dd["ch"], list(dd["ch_mult"]), dd["num_res_blocks"], dd["z_channels"]
    c = ch * mult[-1]
    f = conv(b, h, w, embed_dim, z, 1) + conv(b, h, w, z, c, 3) + _vae_mid(b, h, w, c)
    hh, ww = h, w
    for i in reversed(range(len(mult))):
        for _ in range(nrb + 1):
            f += _vae_res(b, hh, ww, c, ch * mult[i])
            c = ch * mult[i]
        if i:
            hh, ww = hh * 2, ww * 2
            f += conv(b, hh, ww, c, c, 3)
    return f + conv(b, hh, ww, c, dd["out_ch"], 3)


def label_encoder(p: dict, b: int) -> float:
    d, n, ff = p["emb_dim"], p["max_len"], p.get("dim_feedforward", 2048)
    per = (linear(b * n, d, 3 * d) + attn(b, p["n_heads"], n, n, d // p["n_heads"])
           + linear(b * n, d, d) + linear(b * n, d, ff) + linear(b * n, ff, d))
    return p["n_trans_layers"] * per


# -- the kernels' work ---------------------------------------------------------

def flash_fwd_work(b: int, heads: int, n: int, d: int) -> Tuple[float, float]:
    """(operations, bytes) of a bf16 self-attention forward: q, k, v read
    once, the output and the fp32 log-sum-exp written once."""
    return attn(b, heads, n, n, d), 4 * b * n * heads * d * 2 + 4 * b * heads * n


def flash_bwd_work(b: int, heads: int, n: int, d: int) -> Tuple[float, float]:
    """(operations, bytes) of its backward from q, k, v, o, do and the
    log-sum-exp: five products (s = q·kᵀ again, dv, dp, dq, dk), and
    dq, dk, dv written once."""
    return 2.5 * attn(b, heads, n, n, d), 8 * b * n * heads * d * 2 + 4 * b * heads * n


def geglu_work(m: int, c: int) -> Tuple[float, float]:
    """(operations, bytes) of a bf16 GEGLU feed-forward on m rows of width c:
    x·W1 (c → 8c), the gate, ·W2 (4c → c); x, the weights and biases read
    once, the output written once."""
    return linear(m, c, 8 * c) + linear(m, 4 * c, c), 2 * (2 * m * c + 12 * c * c + 9 * c)


def least_seconds(flops: float, moved: float, rate: str = "bf16") -> float:
    """The least time an H100 could take for the work: bound by operations
    or by bytes, whichever is larger."""
    return max(flops / PEAK_FLOPS[rate], moved / HBM_BYTES_PER_S)


# -- a served group and a fine-tuning step -----------------------------------------

def graph_parts(graph: dict):
    net = graph["network_config"]["params"]
    vae = graph["first_stage_config"]["params"]
    le = next(e for e in graph["conditioner_config"]["params"]["emb_models"]
              if e["target"].endswith("LabelEncoder"))["params"]
    return net, vae, le


def serve_group(graph: dict, bucket: int, size: int, steps: int, candidates: int) -> float:
    """Operations of one sampled group of `bucket` rows at size², the
    sequential init-noise search of `candidates` 2-step rollouts and
    `steps` Euler steps, each a UNet eval on the CFG-doubled rows (the
    context K/V once for the search and once for the loop)."""
    net, vae, le = graph_parts(graph)
    f = vae["ddconfig"]["ch_mult"]
    lat = size // 2 ** (len(f) - 1)
    ctx = le["max_len"]
    evals = 2 * candidates + steps
    unet = forward(unet_ops(net, 2 * bucket, lat, lat, ctx, with_kv=False))
    kv = forward(unet_ops(net, 2 * bucket, lat, lat, ctx)) - unet
    return (label_encoder(le, bucket) + vae_encode(vae["ddconfig"], vae["embed_dim"], bucket, size, size)
            + evals * unet + (2 if candidates else 1) * kv
            + vae_decode(vae["ddconfig"], vae["embed_dim"], bucket, lat, lat))


def train_micro_batch(graph: dict, b: int, size: int) -> float:
    """Operations of one micro-batch of fine-tuning: two VAE encodes
    (image, masked image) and the LabelEncoder without gradients, the
    UNet's forward and its backward into the trainable branches."""
    net, vae, le = graph_parts(graph)
    lat = size // 2 ** (len(vae["ddconfig"]["ch_mult"]) - 1)
    ops = unet_ops(net, b, lat, lat, le["max_len"], trainable=tuple(graph.get("opt_keys", ())))
    return (2 * vae_encode(vae["ddconfig"], vae["embed_dim"], b, size, size)
            + label_encoder(le, b) + forward(ops) + backward(ops))
