"""udifftext_tpu_torch — the PyTorch/CUDA port of udifftext_tpu.

UDiffText in PyTorch: the inference path (LabelEncoder conditioning,
init-noise search, CFG Euler-EDM sampling, VAE decode), fine-tuning (with
the OCR loss term over a frozen PARSeq), the training data pipeline,
checkpoint loading and serving, with hand-written Hopper kernels for flash
attention and the GEGLU feed-forward. Public functions keep the JAX
package's layouts: images and latents NHWC (B, H, W, C), attention
(B, N, H, D). The JAX package `udifftext_tpu` is the reference the port is
tested against; this package never imports JAX.
"""

__version__ = "0.1.0"
