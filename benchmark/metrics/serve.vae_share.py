"""The autoencoder's share of a served group's device time: the device
seconds of the `vae.encode` (the masked image) and `vae.decode` spans over
those of the predictor's stages of the traced groups (as in
serve.search_share)."""

from benchmark.spans import device_seconds, program_spans

STAGES = ("predict.upload", "sample.condition", "sample.search", "sample.loop", "sample.decode")


def read(r):
    return share(program_spans())


def share(spans):
    part = device_seconds(spans, ("vae.encode", "vae.decode"))
    whole = device_seconds(spans, STAGES)
    return 100.0 * part / whole if part > 0 and whole > 0 else None
