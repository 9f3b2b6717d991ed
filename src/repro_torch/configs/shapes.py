"""Assigned input shapes (counterpart of repro/configs/shapes.py, copied:
the port imports nothing of the reference).

Each shape names a step kind (launch/steps.py):
  train_4k    -> train_step      (global_batch x seq_len tokens + labels)
  prefill_32k -> serve_prefill   (build a KV cache / SSM state)
  decode_32k  -> serve_decode    (ONE new token against a seq_len cache)
  long_500k   -> serve_decode    (sub-quadratic attention required; dense
                                  archs use the sliding-window variant,
                                  SSM/hybrid decode natively)
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # train | prefill | decode
    long_context: bool = False


SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",  524_288,    1, "decode",
                              long_context=True),
}


def get_shape(name: str) -> InputShape:
    return SHAPES[name]
