"""The least time of a frame's NRC training (the `train` pass), for
nrc_train_roofline.

A frame trains its records over a few Adam steps. At the least it must
read each record once (its query of 14 float32, its target of 3 float32
and its valid byte), and in each step read the hash table and the MLP's
weights once and write their gradients once, and read (parameter,
gradient, both Adam moments, EMA) and write (parameter, both moments,
EMA) every parameter for Adam and the EMA: 4 B x (2 + 9) a parameter a
step. Its operations are the MLP's forward and backward products, 6 x
the multiply-adds of the forward passes (the encoding's arithmetic left
out). The bound is the longer of the bytes at the HBM3 bandwidth of an
H100 SXM (3.35 TB/s) and the operations at its dense bfloat16
tensor-core peak (989 TFLOP/s), so that no implementation, fused or on
tensor cores, reads above 100%.

The work comes from the port's counters alone (records, parameters and
multiply-adds, each from the tensors' shapes), not from a configuration
nor from the names of the kernels that do it. A record is a slot of the
frame's batch, valid or masked: the port cannot count the valid ones
without reading the device, and every slot goes through its encoding and
MLP, the mask applying in the loss."""

from __future__ import annotations

from yardstick import HBM_BYTES_PER_S

TENSOR_FLOP_PER_S = 989e12
RECORD_BYTES = 4 * (14 + 3) + 1
PARAM_BYTES_PER_STEP = 4 * (2 + 9)


def train_bytes(rows: float, params: float) -> float:
    """`rows` records read once; `params` parameters updated, summed over
    the steps."""
    return rows * RECORD_BYTES + params * PARAM_BYTES_PER_STEP


def train_flops(macs: float) -> float:
    """Forward and backward products of `macs` forward multiply-adds."""
    return 6.0 * macs


def train_bound_s(rows: float, params: float, macs: float) -> float:
    """The least time of a frame's training."""
    return max(train_bytes(rows, params) / HBM_BYTES_PER_S,
               train_flops(macs) / TENSOR_FLOP_PER_S)


def counted_work():
    """(records, parameters updated, forward multiply-adds) a frame
    trained, from the port's counters since the process began
    (nrc.train_rows, nrc.train_params, nrc.train_macs over nrc.frames), or
    None where it counted no NRC frame or not that work."""
    try:
        from gfxexp_torch.utils import trace
    except ImportError:
        return None
    c = trace.counters("nrc.")
    frames = c.get("nrc.frames", 0)
    keys = ("nrc.train_rows", "nrc.train_params", "nrc.train_macs")
    if not frames or not all(c.get(k) for k in keys):
        return None
    return tuple(c[k] / frames for k in keys)
