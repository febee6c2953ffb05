"""The plain reference of UDiffText's SD-2 layout. A configuration's
reference package exports these names (benchmark/modules.py)."""

from .engine import CHARSET, NUM_CLASSES, Reference, encode_text, fp32_products, train_steps
from .model import FP32, BFloat16, Float8, Networks, is_embedding, is_norm_param

__all__ = ["CHARSET", "NUM_CLASSES", "Reference", "encode_text", "fp32_products", "train_steps",
           "FP32", "BFloat16", "Float8", "Networks", "is_embedding", "is_norm_param"]
