"""The init-noise search's share of a served group's device time: the
device seconds between the CUDA events of the `sample.search` spans over
those of the predictor's stages (`predict.upload` and `engine.sample`'s
`sample.condition`, `.search`, `.loop`, `.decode`) of the traced groups.
The stages are a group's device work but for its finalize's copy of the
finished images to the host, which for the last traced group falls after
the profiler window, where the recorder no longer records."""

from benchmark.spans import device_seconds, program_spans

STAGES = ("predict.upload", "sample.condition", "sample.search", "sample.loop", "sample.decode")


def read(r):
    return share(program_spans())


def share(spans):
    part, whole = device_seconds(spans, ("sample.search",)), device_seconds(spans, STAGES)
    return 100.0 * part / whole if part > 0 and whole > 0 else None
