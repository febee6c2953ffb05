"""The port's multi-card paths on the CPU: gloo process groups of 2 and 4
processes, started with torchrun's variables as tests/test_torch_dist.py
starts them, on the tiny model graph in fp32.

(a) `predict.Predictor` with a data group of 2 against the JAX package's
    `JittedPredictor(mesh=make_mesh(n_data=2))` on a batch of 2, both fed the
    JAX key's draws: the batched search, and the sequential search with
    attend-and-excite and map capture (6 steps: step 5 iterates). The chosen
    candidate is the JAX one; images, scores, local losses, intermediates
    and maps agree within the single-device parity tests' 1e-3.
(b) `scripts/serve.build_service(dp=2)` against `dp=1` on the same seed, at
    pipeline depths 1 and 2: every row within one uint8 step, the same
    replay coordinates, and `shutdown` ends the other rank's loop.
(c) Tensor parallelism of the fine-tuning step on 1 × 2 and 2 × 2 grids
    (the tiny graph's heads divide: 32 channels, 8 a head): the loss equals
    the JAX `make_train_step(..., state_sharding_tree=state_shardings(...))`
    on the same mesh shape within 2e-4 relative (the JAX TP test's bound),
    the loss and the gathered updated parameters equal one unsharded port
    process within 1e-5, and the replicated gradients are equal on the two
    ranks of a tensor group. A shard followed by a gather is bit-equal.
(d) The rules at full width on the meta device: every parameter that the
    JAX `tp_spec` shards on the flagship tree, mapped through the
    converter's names, is sharded by the port or kept whole with its
    attention (`tp_report`: the five-head ds1 layers at 2 ranks).
(e) A group that fails midway on one rank, between two collectives: the
    first process marks the group broken and refuses later groups, the
    other rank's loop raises, and both processes end.

The children run while the test process works on the JAX side.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_port_util as U
from test_torch_engine import K, _jax_draws, _jax_scores
from test_torch_train import _jax_loss_draws, _seg_batch
from udifftext_tpu.builders import build_diffusion_engine
from udifftext_tpu.parallel import train as JT
from udifftext_tpu.parallel.mesh import make_mesh
from udifftext_tpu.parallel.sharding import state_shardings, tp_spec
from udifftext_tpu.predict import JittedPredictor
from udifftext_tpu_torch.builders import TEXTDESIGN_SD_2_TRAIN, build_engine
from udifftext_tpu_torch.parallel import sharding
from udifftext_tpu_torch.parallel import train as PT
from udifftext_tpu_torch.scripts import serve
from udifftext_tpu_torch.serving import InpaintRequest
from udifftext_tpu_torch.utils import convert

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-3, 1e-3
CFG = 5.0
LR = 5e-5

_CHILD = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from udifftext_tpu_torch.builders import build_engine
from udifftext_tpu_torch.parallel import dist, sharding
from udifftext_tpu_torch.parallel import train as PT
from udifftext_tpu_torch.parallel.mesh import make_groups
from udifftext_tpu_torch.predict import Predictor
from udifftext_tpu_torch.scripts import serve
from udifftext_tpu_torch.serving import InpaintRequest

mode, args = sys.argv[1], json.loads(sys.argv[2])
dist.TIMEOUT_S = args.get("timeout_s", dist.TIMEOUT_S)
dev = dist.maybe_init_distributed("cpu")
rank, world = dist.rank_and_world()
T = lambda a: torch.from_numpy(np.asarray(a))
out = {}
if mode == "predict":
    engine = build_engine(args["cfg"], torch.float32, "cpu").engine
    engine.load_state_dict(torch.load(args["sd"]), strict=True)
    grid = make_groups(world, 1)
    for run in args["runs"]:
        data = np.load(run["data"])
        batch = {k: data[k] for k in data.files if k not in ("eps", "cands")}
        pred = Predictor(engine, data_group=grid.data, **run["kw"])
        images, aux = pred(batch, posterior_eps=T(data["eps"]), noise=T(data["cands"]))
        out[run["name"]] = {"images": images, **aux}
elif mode == "serve":
    data = np.load(args["reqs"])
    reqs = [InpaintRequest(image=data["image"][i], mask=data["mask"][i], text=t)
            for i, t in enumerate(args["texts"])]
    for depth in args["depths"]:
        svc = serve.build_service(args["cfgs"], args["cfg"], "cpu", pipeline=depth, dp=world,
                                  **args["service"])
        if rank:
            out[depth] = svc.serve()
            continue
        res = [f.result(timeout=120) for f in [svc.submit(r) for r in reqs]]
        svc.shutdown()
        out[depth] = {"images": np.stack([r["image"] for r in res]),
                      "coords": [(r["batch_key"], r["row"], r["batch_size"]) for r in res]}
elif mode == "fault":
    from udifftext_tpu_torch.engine import group_sum
    from udifftext_tpu_torch.serving import DataParallelPredictor, DataParallelService

    group = make_groups(world, 1).data

    def run(arr_batch, key):
        group_sum(torch.ones(1), group)  # every rank joins this one
        if rank == args["failing"]:
            raise RuntimeError(f"rank {rank} fails midway")
        group_sum(torch.ones(1), group)  # the others wait here for the failed rank
        return torch.zeros((len(arr_batch["image"]), 16, 16, 3), dtype=torch.uint8)

    front = DataParallelPredictor(run, group, "cpu", 16, 4)
    if rank:
        try:
            out = f"served {front.serve()} groups to the stop header"
        except Exception as e:  # noqa: BLE001 — reported to the test
            out = repr(e)
    else:
        svc = DataParallelService(front, max_batch=2, max_delay_ms=10.0, size=16, seq_len=4, dp=2)
        req = InpaintRequest(image=np.zeros((16, 16, 3), np.uint8),
                             mask=np.ones((16, 16), np.uint8), text="ab")
        out = {}
        for call in ("first", "second"):
            try:
                out[call] = svc.inpaint(req, timeout=60)["batch_key"]
            except Exception as e:  # noqa: BLE001 — reported to the test
                out[call] = repr(e)
        svc.shutdown()
        out["broken"] = front.broken.is_set()
    # the group is out of step: leave without tearing it down, as a failed rank would
    print(json.dumps({"rank": rank, "fault": out}), flush=True)
    os._exit(0)
elif mode == "tp":
    nd, nt = args["grid"]
    engine = build_engine(args["cfg"], torch.float32, "cpu", train=True).engine
    engine.load_state_dict(torch.load(args["sd"]), strict=True)
    grid = make_groups(nd, nt)
    sharding.shard_model_(engine, grid.tensor)
    data = np.load(args["data"])
    b = len(data["image"])
    rows = slice(grid.data_rank * b // nd, (grid.data_rank + 1) * b // nd)
    mb = ({k: T(data[k])[rows] for k in args["batch_keys"]},
          {k: T(data["draw_" + k])[rows] for k in args["draw_keys"]})
    state = PT.TrainState.create(engine, base_lr=args["lr"], steps_per_epoch=1)
    loss, _ = PT.train_step(state, [mb], lambda m: engine.loss(m[0], **m[1]),
                            data_group=grid.data)
    out = {"loss": float(loss), "grid": (grid.data_rank, grid.tensor_rank),
           "params": {n: p.detach().clone() for n, p in engine.named_parameters()},
           "grads": {n: p.grad.clone() for n, p in state.params.items()}}
torch.save(out, f"{args['out']}.{rank}.pt")
print(json.dumps({"rank": rank, "groups": out if mode == "serve" and rank else None}))
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Children:
    """`world` processes of the child script in one gloo group."""

    def __init__(self, world: int, mode: str, args: dict):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
                   MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world))
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", _CHILD, mode, json.dumps(args)],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]

    def wait(self, timeout: float = 240):
        try:
            results = [p.communicate(timeout=timeout) for p in self.procs]
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
        outs = []
        for p, (out, err) in zip(self.procs, results):
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
        return outs


@pytest.fixture(scope="module")
def jax_engine():
    cfg = U.tiny_model_cfg()
    je = build_diffusion_engine(cfg, unet_dtype=jnp.float32).engine
    return cfg, je


def _save_port_weights(params, path: Path) -> str:
    torch.save(convert.engine_from_jax(params), path)
    return str(path)


# --- (a) data-parallel prediction against the JAX mesh predictor ------------


def test_data_parallel_predictor_matches_jax_mesh(jax_engine, tmp_path):
    cfg, je = jax_engine
    params = U.engine_params(je, seed=11)
    b, key_seeds = 2, {"batched": 21, "sequential_aae": 33}
    settings = {"batched": dict(num_steps=4, noise_search_batched=True),
                "sequential_aae": dict(num_steps=6, aae_enabled=True, detailed=True)}
    nb = U.numpy_batch(b, seed=5)
    runs, draws = [], {}
    for name, seed in key_seeds.items():
        key = jax.random.PRNGKey(seed)
        draws[name] = (key,) + _jax_draws(key, b)
        eps, cands = draws[name][3:]
        np.savez(tmp_path / f"{name}.npz", eps=eps, cands=cands, **nb)
        runs.append({"name": name, "data": str(tmp_path / f"{name}.npz"),
                     "kw": dict(cfg_scale=CFG, noise_iters=K, **settings[name])})
    kids = Children(2, "predict", {"cfg": cfg, "sd": _save_port_weights(params, tmp_path / "w.pt"),
                                   "runs": runs, "out": str(tmp_path / "pred")})

    mesh = make_mesh(n_data=2, devices=jax.devices("cpu")[:2])
    jb = U.to_jax(nb)
    want = {}
    for name, (key, rng_cond, _, _, cands) in draws.items():
        pred = JittedPredictor(je, mesh=mesh, cfg_scale=CFG, noise_iters=K, **settings[name])
        with mesh:
            img, aux = pred(params, nb, key)
        c, uc = je.conditionings(params, jb, rng=rng_cond)
        want[name] = {"images": np.asarray(img), "scores": _jax_scores(je, params, c, uc, jb, cands),
                      **{k: np.asarray(v) for k, v in aux.items()}}
    kids.wait()

    got = torch.load(tmp_path / "pred.0.pt", weights_only=False)
    for name, w in want.items():
        g = got[name]
        scores, want_scores = g.pop("noise_scores"), w.pop("scores")
        U.assert_close(scores, want_scores, RTOL, 1e-5, f"{name} scores")
        assert int(torch.argmin(scores)) == int(np.argmin(want_scores)), name  # the candidate
        assert set(g) == set(w), (name, sorted(g), sorted(w))
        for k, v in w.items():
            U.assert_close(g[k], v, RTOL, ATOL, f"{name} {k}")
    assert got["sequential_aae"]["local_losses"].shape == (6, b)
    assert sum(k.endswith("t_attn") for k in got["sequential_aae"]) == 7


# --- (b) data-parallel serving against one process ---------------------------


def test_data_parallel_service_matches_one_process(jax_engine, tmp_path):
    """Six requests, max batch 4, buckets (2, 4): a group of 4 and a group
    of 2 (the second waits out its deadline), on 2 ranks and on 1."""
    cfg = jax_engine[0]
    cfgs = {"load_ckpt_path": None, "bf16": False, "H": U.IMG, "seq_len": U.SEQ, "steps": 2,
            "scale": [CFG, 0.0], "noise_iters": 2}
    service = dict(max_batch=4, max_delay_ms=1000.0, buckets=[2, 4], seed=3,
                   noise_search_batched=True)
    rs = np.random.RandomState(7)
    texts = ["ab", "cd", "xyz", "q", "hello", "z9"]
    image = rs.randint(0, 255, (len(texts), U.IMG, U.IMG, 3)).astype(np.uint8)
    grid = np.arange(U.IMG)[:, None] + np.arange(U.IMG)[None, :]
    mask = np.stack([(grid > 10 + 3 * i).astype(np.uint8) for i in range(len(texts))])
    np.savez(tmp_path / "reqs.npz", image=image, mask=mask)
    depths = [1, 2]
    kids = Children(2, "serve", {"cfgs": cfgs, "cfg": cfg, "reqs": str(tmp_path / "reqs.npz"),
                                 "texts": texts, "depths": depths, "service": service,
                                 "out": str(tmp_path / "serve")})
    want = {}
    for depth in depths:
        svc = serve.build_service(cfgs, cfg, "cpu", pipeline=depth, **service)
        res = [f.result(timeout=120) for f in [
            svc.submit(InpaintRequest(image=image[i], mask=mask[i], text=t))
            for i, t in enumerate(texts)]]
        svc.shutdown()
        want[depth] = (np.stack([r["image"] for r in res]),
                       [(r["batch_key"], r["row"], r["batch_size"]) for r in res])
    outs = kids.wait()
    # the other rank's loop ended at shutdown, after the two groups of each depth
    assert outs[1]["groups"] == {str(d): 2 for d in depths}
    got = torch.load(tmp_path / "serve.0.pt", weights_only=False)
    for depth in depths:
        images, coords = want[depth]
        assert coords == [(0, 0, 4), (0, 1, 4), (0, 2, 4), (0, 3, 4), (1, 0, 2), (1, 1, 2)]
        assert [tuple(c) for c in got[depth]["coords"]] == coords
        diff = np.abs(got[depth]["images"].astype(np.int32) - images.astype(np.int32))
        assert diff.max() <= 1, (depth, diff.max())
        assert images.std() > 0


# --- (c) tensor parallelism of the fine-tuning step --------------------------


BATCH_KEYS = ("image", "masked", "mask", "seg", "seg_mask", "label_ids")


def _jax_tp_loss(je, params, batch, key, nd, nt) -> float:
    """The JAX TP step's loss on an nd × nt mesh (the JAX TP test's recipe)."""
    mesh = make_mesh(n_data=nd, n_tensor=nt, devices=jax.devices("cpu")[:nd * nt])
    opt = JT.make_optimizer(params, base_lr=LR, steps_per_epoch=1)
    state = JT.TrainState.create(params, opt)
    sh = state_shardings(mesh, jax.eval_shape(lambda: state))
    step = JT.make_train_step(je.loss, opt, mesh=mesh, donate=False, state_sharding_tree=sh)
    with mesh:
        _, loss, _ = step(state, U.to_jax(batch), key)
    return float(loss)


def test_tensor_parallel_step_matches_jax_and_one_process(jax_engine, tmp_path):
    cfg, je = jax_engine
    params = U.engine_params(je, seed=13)
    b = 4
    batch = {k: v for k, v in _seg_batch(b, 2).items() if k in BATCH_KEYS}
    key = jax.random.PRNGKey(5)
    draws = _jax_loss_draws(key, b)
    np.savez(tmp_path / "batch.npz", **batch, **{f"draw_{k}": v for k, v in draws.items()})
    sd_path = _save_port_weights(params, tmp_path / "w.pt")
    args = {"cfg": cfg, "sd": sd_path, "data": str(tmp_path / "batch.npz"), "lr": LR,
            "batch_keys": list(batch), "draw_keys": list(draws)}
    grids = {"1x2": (1, 2), "2x2": (2, 2)}
    kids = {name: Children(nd * nt, "tp", dict(args, grid=[nd, nt], out=str(tmp_path / name)))
            for name, (nd, nt) in grids.items()}

    # one unsharded port process
    engine = U.load_port(build_engine(cfg, torch.float32, "cpu", train=True).engine,
                         torch.load(sd_path))
    state = PT.TrainState.create(engine, base_lr=LR, steps_per_epoch=1)
    mb = ({k: torch.from_numpy(v) for k, v in batch.items()},
          {k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    loss, _ = PT.train_step(state, [mb], lambda m: engine.loss(m[0], **m[1]))
    want = {n: p.detach() for n, p in engine.named_parameters()}
    jax_losses = {name: _jax_tp_loss(je, params, batch, key, *g) for name, g in grids.items()}

    for name, (nd, nt) in grids.items():
        kids[name].wait()
        parts = [torch.load(tmp_path / f"{name}.{r}.pt", weights_only=False)
                 for r in range(nd * nt)]
        assert [p["grid"] for p in parts] == [(r // nt, r % nt) for r in range(nd * nt)]
        U.assert_close(parts[0]["loss"], jax_losses[name], 2e-4, 0, f"{name} loss vs JAX")
        for p in parts:
            U.assert_close(p["loss"], float(loss), 1e-5, 0, f"{name} loss vs one process")
        plan = sharding.tp_plan(engine, nt)
        assert not plan.whole and plan.rules
        for d in range(nd):
            ranks = parts[d * nt:(d + 1) * nt]
            got = sharding.gather_state_dict([p["params"] for p in ranks], plan)
            assert set(got) == set(want)
            for n, w in want.items():
                U.assert_close(got[n], w.numpy(), 0, 1e-5, f"{name} data rank {d}: {n}")
            grads = [p["grads"] for p in ranks]
            replicated = [n for n in grads[0] if n not in plan.rules]
            assert any("t_norm" in n for n in replicated)
            assert any(n.endswith("to_out.0.bias") for n in replicated)
            for n in replicated:
                assert all(torch.equal(g[n], grads[0][n]) for g in grads[1:]), n
        # the trainable shards moved and the frozen ones did not
        moved = [n for n in plan.rules if "t_attn" in n
                 and not torch.equal(parts[0]["params"][n], sharding.shard_tensor(
                     torch.load(sd_path)[n], plan.rules[n], 0, nt))]
        assert moved and all("t_attn" in n for n in moved)


@pytest.mark.parametrize("n_tensor", [2, 4])
def test_shard_then_gather_is_bit_equal(jax_engine, n_tensor):
    engine = build_engine(jax_engine[0], torch.float32, "cpu").engine
    torch.manual_seed(0)
    sd = {k: torch.randn(v.shape) for k, v in engine.state_dict().items()}
    plan = sharding.tp_plan(engine, n_tensor)
    shards = [sharding.shard_state_dict(sd, t, n_tensor, plan) for t in range(n_tensor)]
    name = "unet.input_blocks.1.1.transformer_blocks.0.ff.net.0.proj.weight"
    inner = sd[name].shape[0] // 2
    part = inner // n_tensor
    # rank 1's GEGLU rows are [h_1 | g_1]
    assert torch.equal(shards[1][name], torch.cat([sd[name][part:2 * part],
                                                   sd[name][inner + part:inner + 2 * part]]))
    full = sharding.gather_state_dict(shards, plan)
    assert set(full) == set(sd) and all(torch.equal(full[k], v) for k, v in sd.items())


# --- (d) the rules at full width ----------------------------------------------


def _port_name(path) -> str:
    """The port's state-dict name of a JAX UNet parameter path."""
    keys = [str(getattr(p, "key", p)) for p in path]
    mods = keys[2:-1]  # ['unet']['params'] ... leaf
    if mods and mods[-1] in convert._WRAPPERS:
        mods.pop()
    leaf = convert._tensor(keys[-1], np.zeros((1, 1), np.float32))[0]
    return ".".join(["unet"] + convert._unet_path(mods) + [leaf])


def test_full_width_rules_cover_the_jax_rules():
    from udifftext_tpu.loading import init_engine_params

    n_tensor = 2
    bundle = build_diffusion_engine(TEXTDESIGN_SD_2_TRAIN, unet_dtype=jnp.bfloat16)
    params_abs = jax.eval_shape(lambda: init_engine_params(bundle, jax.random.PRNGKey(0)))
    sharded = []
    jax.tree_util.tree_map_with_path(
        lambda p, l: sharded.append(_port_name(p)) if tp_spec(p, l) != P() else None, params_abs)
    assert len(sharded) == 160  # 16 transformer layers × 10 kernels

    engine = build_engine(TEXTDESIGN_SD_2_TRAIN, torch.bfloat16, "meta", train=True).engine
    names = dict(engine.named_parameters())
    plan = sharding.tp_plan(engine, n_tensor)
    assert set(plan.rules) <= set(names)
    whole = set(sharding.tp_report(engine, n_tensor))
    uncovered = [n for n in sharded if n not in plan.rules
                 and not any(n.startswith(w + ".") for w in whole)]
    assert uncovered == []
    # the five-head ds1 attention stays whole, every feed-forward shards
    ds1 = {f"unet.{p}.1.transformer_blocks.0.{a}" for p in
           ("input_blocks.1", "input_blocks.2", "output_blocks.9", "output_blocks.10",
            "output_blocks.11") for a in ("attn1", "t_attn")}
    assert whole == ds1
    heads = {n: m.heads for n, m in engine.named_modules() if n in ds1}
    assert set(heads.values()) == {5}
    ff = [n for n in plan.rules if n.endswith("ff.net.0.proj.weight")]
    assert len(ff) == 16
    for n in ff:
        inner = names[n].shape[0] // 2
        assert inner % (64 * n_tensor) == 0 and (inner // n_tensor) in (640, 1280, 2560)


# --- (e) a group that fails midway --------------------------------------------


@pytest.mark.parametrize("failing", [0, 1])
def test_a_group_failing_midway_ends_every_rank(failing, tmp_path):
    """One rank raises between two of a group's collectives while the other
    waits in the second: the first process marks the group broken, fails
    that group's requests and refuses the next, and the other rank's loop
    raises instead of serving on; both processes end (the gloo group's
    timeout is cut to 20 s, so a rank left waiting ends within it too)."""
    kids = Children(2, "fault", {"failing": failing, "timeout_s": 20,
                                 "out": str(tmp_path / "fault")})
    t0 = time.monotonic()
    outs = kids.wait(timeout=120)
    assert time.monotonic() - t0 < 100
    first = outs[0]["fault"]
    assert first["broken"] is True
    assert isinstance(first["first"], str) and "Error" in first["first"]
    if failing == 0:
        assert "rank 0 fails midway" in first["first"]
    assert "broken by a failed group" in first["second"]
    assert "Error" in outs[1]["fault"] and "stop header" not in outs[1]["fault"]
    if failing == 1:
        assert "rank 1 fails midway" in outs[1]["fault"]
