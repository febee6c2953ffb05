"""ABINet language-model word accuracy from ground-truth input (port of
`scripts/str_abinet_lm_acc.py`; src/parseq/tools/test_abinet_lm_acc.py
parity).

Feeds each benchmark set's ground-truth labels (as one-hot token
distributions) straight into ABINet's BCN cloze language model and measures
how often the LM reproduces the word: the LM's spelling accuracy with a
perfect vision front end.

Encoding semantics (:23-36 upstream): charset is ascii_lowercase+'1234567890'
with the strhub Tokenizer layout (EOS id 0 first, charset, BOS, PAD); targets
are the bare char ids zero(EOS)-padded to max_label_length+1=26 columns,
one-hot over the first 37 classes (EOS+charset — BOS/PAD sliced off);
lengths are len(label)+1. The LM reads each sample on its own, so the last
batch of a set runs at its own size (the JAX script pads it to one shape).

Usage: python -m udifftext_tpu_torch.scripts.str_abinet_lm_acc --data_root <root>
       [--ckpt abinet.pt] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import string
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.abinet import BCNLanguage
from ..models.parseq import ParseqTokenizer
from ..str_eval import evaluate_predictions, sequence_confidence
from ._timing import probe_device
from .str_test import TEST_BENCHMARK, TEST_NEW, load_folder, print_results_table

# original ABINet charset (test_abinet_lm_acc.py:53)
LM_CHARSET = string.ascii_lowercase + "1234567890"
MAX_LEN = 26  # max_label_length + 1
NUM_CLASSES = len(LM_CHARSET) + 1  # + EOS


def encode_labels(labels) -> Tuple[np.ndarray, np.ndarray]:
    """(B, 26, 37) one-hot targets + (B,) lengths, ABINetLM._encode parity."""
    stoi = {c: i + 1 for i, c in enumerate(LM_CHARSET)}
    ids = np.zeros((len(labels), MAX_LEN), np.int32)  # pad id 0 == EOS
    lengths = np.zeros((len(labels),), np.int32)
    for i, label in enumerate(labels):
        row = [stoi[c] for c in label]
        ids[i, :len(row)] = row
        lengths[i] = len(label) + 1
    onehot = np.zeros((len(labels), MAX_LEN, NUM_CLASSES), np.float32)
    np.put_along_axis(onehot, ids[..., None], 1.0, axis=-1)
    return onehot, lengths


def language_model(ckpt: Optional[str], device: torch.device) -> BCNLanguage:
    """ABINet's BCNLanguage in eval mode on `device`: taken from a strhub
    ABINet checkpoint, or PyTorch's initial weights from seed 0 (with a
    warning) when there is none."""
    from ..models.str_hub import _BASE_CONFIGS, create_model

    if ckpt:
        return create_model("abinet", ckpt, device=device).language
    print("warning: random weights")
    torch.manual_seed(0)
    cfg = _BASE_CONFIGS["abinet"]
    lm = BCNLanguage(max_length=cfg["max_length"], num_classes=cfg["num_classes"],
                     d_model=cfg["d_model"])
    return lm.to(device).eval()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--ckpt", default=None, help="abinet checkpoint (.pt)")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--new", action="store_true",
                    help="Evaluate on new benchmark datasets")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = probe_device("str_abinet_lm_acc", args.device)

    lm = language_model(args.ckpt, device)
    tokenizer = ParseqTokenizer(charset=LM_CHARSET)

    test_set = TEST_BENCHMARK + (TEST_NEW if args.new else ())
    results = {}
    for name in sorted(set(test_set)):
        # labels adapt to the LM charset at load and over-length or empty
        # samples are excluded, as in the upstream datamodule
        items = load_folder(os.path.join(args.data_root, name), charset=LM_CHARSET)
        if not items:
            print(f"skipping {name} (no data)")
            continue
        gts = [g for _, g in items]  # LM-only evaluation never opens the images
        preds, confs = [], []
        for i in range(0, len(gts), args.batch):
            tokens, lengths = encode_labels(gts[i:i + args.batch])
            with torch.no_grad():
                logits = lm(torch.as_tensor(tokens, device=device),
                            torch.as_tensor(lengths, device=device))["logits"]
            logits = logits.float().cpu().numpy()
            preds += tokenizer.decode_ids(logits.argmax(-1))
            confs += sequence_confidence(logits)
        results[name] = evaluate_predictions(preds, gts, confs, charset_test=LM_CHARSET)

    groups = {"Benchmark": TEST_BENCHMARK}
    if args.new:
        groups["New"] = TEST_NEW
    for group, subset in groups.items():
        rows = [(s, results[s]) for s in subset if s in results]
        if rows:
            print(f"{group} set:")
            print_results_table(rows)
    return results


if __name__ == "__main__":
    main()
