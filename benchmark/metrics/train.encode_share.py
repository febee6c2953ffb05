"""The autoencoder encodes' share of a fine-tuning step's device time: the
device seconds of the `vae.encode` spans (the image and the masked image
of every micro-batch, inside `loss.forward`) over those of the steps'
`train.to_device` and `train.step` spans, over the traced steps."""

from benchmark.spans import device_seconds, program_spans


def read(r):
    return share(program_spans())


def share(spans):
    part = device_seconds(spans, ("vae.encode",))
    whole = device_seconds(spans, ("train.to_device", "train.step"))
    return 100.0 * part / whole if part > 0 and whole > 0 else None
