"""Quality gate for the APPROXIMATE encoder-propagation sampling mode
(the port's copy of `udifftext_tpu/utils/encprop_gate.py`: the same report
directory, file names, JSON, checkpoint ids and environment variables, so a
report written by either package gates the other).

`encprop_interval > 1` replaces the exact Euler-EDM sampler with an
approximation ("Faster Diffusion", arXiv 2312.09608) whose quality cost
depends on the checkpoint:

- ``python -m udifftext_tpu_torch.scripts.encprop_quality`` measures the
  PSNR of the approximate mode against the exact sampler for a loaded
  checkpoint and writes a report JSON keyed by the checkpoint's content
  hash (``write_report``).
- ``Predictor`` calls ``gate_encprop`` at construction: with a known
  checkpoint identity and NO report (or a report below ``min_psnr``) it
  REFUSES; with no checkpoint identity (random init, programmatic weights)
  it warns once per process.
- ``UDIFFTEXT_ENCPROP_UNGATED=1`` bypasses the gate (warns once): for
  benchmarking the mode's throughput, never for production.

Reports live under ``$UDIFFTEXT_ENCPROP_REPORTS`` (default
``./encprop_reports``).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import Any, Dict, Optional

DEFAULT_MIN_PSNR = 30.0
QUALITY_SCRIPT = "python -m udifftext_tpu_torch.scripts.encprop_quality"
_WARNED: set = set()


def report_dir() -> str:
    return os.environ.get("UDIFFTEXT_ENCPROP_REPORTS", "./encprop_reports")


def report_path(ckpt_id: str) -> str:
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in ckpt_id)
    return os.path.join(report_dir(), f"encprop_{safe}.json")


def ckpt_file_id(path: Optional[str]) -> Optional[str]:
    """Content hash of a checkpoint: sha256 of the file bytes, or — for an
    orbax directory — of each file's (relpath, size, head+tail bytes). None
    when the path is absent (fresh init), in which case the gate can only
    warn.

    The directory form samples the first and last 64 KiB of every file (not
    just the size manifest): two checkpoints of the same model have identical
    layouts and chunk sizes, so a size-only manifest would collide and let a
    stale quality report admit encprop for weights that were never measured.
    Sampled content differs between any two real weight sets while keeping
    the hash O(files), not O(bytes)."""
    if not path or not os.path.exists(str(path)):
        return None
    path = str(path)
    h = hashlib.sha256()
    if os.path.isfile(path):
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 22), b""):
                h.update(chunk)
        return h.hexdigest()[:16]
    sample = 1 << 16
    for root, _dirs, files in sorted(os.walk(path)):
        for name in sorted(files):
            fp = os.path.join(root, name)
            size = os.path.getsize(fp)
            h.update(os.path.relpath(fp, path).encode())
            h.update(str(size).encode())
            with open(fp, "rb") as f:
                h.update(f.read(sample))
                if size > 2 * sample:
                    f.seek(-sample, os.SEEK_END)
                    h.update(f.read(sample))
    return h.hexdigest()[:16]


def ckpt_id_if_encprop(cfgs) -> Optional[str]:
    """The gate's checkpoint id for a run config: `ckpt_file_id` of its
    `load_ckpt_path` when its `encprop_interval` is > 1, else None (hashing
    a checkpoint of several GB is not free)."""
    if int(cfgs.get("encprop_interval", 0)) <= 1:
        return None
    return ckpt_file_id(cfgs.get("load_ckpt_path"))


def write_report(ckpt_id: str, payload: Dict[str, Any]) -> str:
    """Persist a quality report; `payload["intervals"]` maps str(interval) ->
    {"psnr": dB, ...}. Returns the path written.

    Merges with an existing report for the same checkpoint when the sampler
    settings (steps/scale/size) match — so measuring --intervals 2 then
    --intervals 3 accumulates instead of dropping the first measurement.
    Mismatched settings overwrite wholesale: intervals measured under
    different settings must not coexist in one report (the gate compares
    the report's settings against the predictor's)."""
    os.makedirs(report_dir(), exist_ok=True)
    out = report_path(ckpt_id)
    merged = {"ckpt_id": ckpt_id, **payload}
    prev = load_report(ckpt_id)
    if prev is not None and all(
        prev.get(k) == payload.get(k) for k in ("steps", "scale", "size")
    ):
        intervals = dict(prev.get("intervals") or {})
        intervals.update(payload.get("intervals") or {})
        merged["intervals"] = intervals
    with open(out, "w") as f:
        json.dump(merged, f, indent=1)
    return out


def load_report(ckpt_id: str) -> Optional[Dict[str, Any]]:
    p = report_path(ckpt_id)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def _warn_once(key: str, msg: str) -> None:
    if key in _WARNED:
        return
    _WARNED.add(key)
    print(f"WARNING: {msg}", file=sys.stderr)


def gate_encprop(
    ckpt_id: Optional[str],
    interval: int,
    min_psnr: float = DEFAULT_MIN_PSNR,
    settings: Optional[Dict[str, Any]] = None,
) -> None:
    """Refuse (raise RuntimeError) or warn before approximate sampling runs.

    Call with the loaded checkpoint's ``ckpt_file_id`` and the configured
    ``encprop_interval`` (> 1). ``settings`` ({"steps": N, "scale": S}) is
    the predictor's sampler configuration: encprop quality is strongly
    steps-dependent, so a report measured at different settings is not
    evidence — mismatches refuse, reports predating the settings fields
    warn once."""
    if interval <= 1:
        return
    if os.environ.get("UDIFFTEXT_ENCPROP_UNGATED"):
        _warn_once(
            "ungated",
            "encprop quality gate BYPASSED (UDIFFTEXT_ENCPROP_UNGATED) — "
            "approximate sampling with no quality enforcement",
        )
        return
    if ckpt_id is None:
        _warn_once(
            "no-ckpt",
            f"encprop_interval={interval} requested with no checkpoint "
            "identity (fresh init or programmatic params) — the approximate "
            "sampler's quality is UNVALIDATED for these weights. Run "
            f"{QUALITY_SCRIPT} against the real checkpoint before "
            "trusting outputs.",
        )
        return
    rep = load_report(ckpt_id)
    if rep is None:
        raise RuntimeError(
            f"encprop_interval={interval} refused: no quality report for "
            f"checkpoint {ckpt_id} (looked in {report_path(ckpt_id)}). Run\n"
            f"  {QUALITY_SCRIPT} --ckpt <that checkpoint>\n"
            "to measure and record PSNR vs the exact sampler, or set "
            "UDIFFTEXT_ENCPROP_UNGATED=1 to bypass (benchmarks only)."
        )
    if settings:
        mismatched = {
            k: (rep.get(k), v)
            for k, v in settings.items()
            if rep.get(k) is not None and rep.get(k) != v
        }
        if mismatched:
            detail = ", ".join(
                f"{k}: report={a!r} vs requested={b!r}" for k, (a, b) in mismatched.items()
            )
            raise RuntimeError(
                f"encprop_interval={interval} refused: the quality report for "
                f"{ckpt_id} was measured under different sampler settings "
                f"({detail}) — its PSNR is not evidence for this "
                f"configuration. Re-run {QUALITY_SCRIPT} with the "
                "production settings."
            )
        missing = [k for k in settings if rep.get(k) is None]
        if missing:
            _warn_once(
                f"no-settings-{ckpt_id}",
                f"encprop quality report for {ckpt_id} predates recorded "
                f"sampler settings ({missing}) — cannot confirm it matches "
                f"this configuration. Re-run {QUALITY_SCRIPT} to "
                "refresh it.",
            )
    entry = (rep.get("intervals") or {}).get(str(interval))
    if entry is None:
        raise RuntimeError(
            f"encprop_interval={interval} refused: quality report for "
            f"{ckpt_id} has no measurement for interval {interval} "
            f"(measured: {sorted((rep.get('intervals') or {}))}). Re-run "
            f"{QUALITY_SCRIPT} with --intervals including {interval}."
        )
    psnr = float(entry.get("psnr", float("-inf")))
    if psnr < min_psnr:
        raise RuntimeError(
            f"encprop_interval={interval} refused: recorded PSNR {psnr:.2f} dB "
            f"for checkpoint {ckpt_id} is below the {min_psnr:.1f} dB gate. "
            "The approximate mode degrades this checkpoint too much; sample "
            "exactly (encprop_interval=0) or lower the gate knowingly via "
            "Predictor(min_quality_psnr=...)."
        )
    print(
        f"[encprop] quality gate passed: ckpt {ckpt_id} interval {interval} "
        f"PSNR {psnr:.2f} dB (>= {min_psnr:.1f})"
    )
