"""Frozen work count of a field's networks: the operations and bytes of
every matrix product of one train step, forward and backward, and the
least time the card could take for them.

The matrices are the configuration's field's matrix leaves
(`train.is_matrix` over its `leaf_shapes`), (in, out), each taken once a
point. A network is the leaves that share the path before their last
part (`density.w0`, `density.w1`); its last leaf is its last product.
Per leaf and P points:

  forward   2 in out P operations; the input activations read and the
            output written once, the weights read once
  backward  4 in out P operations (the input's gradient and the weight's);
            the output's gradient and the input activations read once, the
            input's gradient and the fp32 weight gradient written once

Activations are counted in the compute dtype, but for each network's last
product, whose input and output are fp32 (`ops/mlp.py`'s rule). Each
product's least time is its operations over the bf16 tensor-core peak or
its bytes over the memory rate, the larger (`work.PEAK_BF16_PER_S`,
`work.PEAK_BYTES_PER_S`); the step's is their sum.
"""

from __future__ import annotations

from portbench.frozen import work
from portbench.reference.train import is_matrix


def products(leaf_shapes: dict) -> list[tuple[int, int, bool]]:
    """(in, out, last of its network) of each matrix leaf, in order."""
    mats = [(name, shape) for name, shape in leaf_shapes.items() if is_matrix(name)]
    net = lambda name: name.rsplit(".", 1)[0] if "." in name else ""
    return [(shape[0], shape[1], i + 1 == len(mats) or net(mats[i + 1][0]) != net(name))
            for i, (name, shape) in enumerate(mats)]


def network_work(leaf_shapes: dict, dtype, o: int, p: int) -> list[tuple[int, int]]:
    """(bytes, operations) of each product's forward and then each one's
    backward, over O objects of P points."""
    t = work._itemsize(dtype)
    n = o * p
    fwd, bwd = [], []
    for cin, cout, last in products(leaf_shapes):
        a = 4 if last else t
        w = o * cin * cout * a
        fwd.append((n * (cin + cout) * a + w, 2 * cin * cout * n))
        bwd.append((n * (2 * cin + cout) * a + o * cin * cout * 4 + w, 4 * cin * cout * n))
    return fwd + bwd


def least_seconds(leaf_shapes: dict, dtype, o: int, p: int) -> float:
    """The least time of the step's network, forward and backward."""
    return sum(max(b / work.PEAK_BYTES_PER_S, f / work.PEAK_BF16_PER_S)
               for b, f in network_work(leaf_shapes, dtype, o, p))
