"""Inputs made from ``--seed``: the weights and the token batches.

Both sides get the same: the program's set-up and, after the window, the
reference regenerate them bit for bit from the seed.  The weights follow
the configuration's file alone (``layout``), not the program: each leaf is
named by its path in the port's parameter tree, and :func:`as_tree` hands
them to the program after checking every path and shape.  Each leaf is
one draw on the device from its own generator, so a leaf can be drawn
again alone.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

#: (path, shape, init, std): init is "normal", "ones" or "zeros"
Leaf = Tuple[str, Tuple[int, ...], str, float]


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for ``tag`` from the run's seed (any integer)."""
    digest = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def head_dim(arch: dict) -> int:
    return arch["head_dim"] or arch["d_model"] // arch["num_heads"]


def check_dense(arch: dict):
    """The layouts here are of dense ``attn`` stacks, one scan group."""
    if list(arch["block_pattern"]) != ["attn"] or arch["num_experts"] \
            or arch["frontend"] != "none":
        raise ValueError(f"{arch['name']}: only dense attn stacks with "
                         f"token inputs are laid out here")


def layout(arch: dict) -> List[Leaf]:
    """Every parameter leaf of the configuration, in draw order."""
    check_dense(arch)
    d, H, KV = arch["d_model"], arch["num_heads"], arch["num_kv_heads"]
    f, V, L, D = arch["d_ff"], arch["vocab_size"], arch["num_layers"], \
        head_dim(arch)
    st = (L,) if L > 1 else ()

    def norm(prefix, lead=st):
        out = [(f"{prefix}/scale", lead + (d,), "ones", 1.0)]
        if arch["norm"] == "layernorm":
            out.append((f"{prefix}/bias", lead + (d,), "zeros", 0.0))
        return out

    leaves = [("embed/tok", (V, d), "normal", d ** -0.5)]
    b = "g0/b0"
    leaves += norm(f"{b}/ln1")
    leaves += [(f"{b}/attn/wq", st + (d, H, D), "normal", d ** -0.5),
               (f"{b}/attn/wk", st + (d, KV, D), "normal", d ** -0.5),
               (f"{b}/attn/wv", st + (d, KV, D), "normal", d ** -0.5),
               (f"{b}/attn/wo", st + (H, D, d), "normal", (H * D) ** -0.5)]
    leaves += norm(f"{b}/ln2")
    leaves += [(f"{b}/ffn/wi", st + (d, f), "normal", d ** -0.5),
               (f"{b}/ffn/wo", st + (f, d), "normal", f ** -0.5)]
    if arch["glu"]:
        leaves.append((f"{b}/ffn/wg", st + (d, f), "normal", d ** -0.5))
    leaves += norm("head/norm", ())
    if not arch["tie_embeddings"]:
        leaves.append(("head/out", (d, V), "normal", d ** -0.5))
    return leaves


def draw_leaf(torch, leaf: Leaf, seed: int, device, dtype):
    """One leaf as the seed makes it: a normal draw in ``dtype`` on the
    device, scaled, or ones or zeros."""
    path, shape, init, std = leaf
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "w/" + path))
    return torch.randn(shape, generator=g, dtype=dtype,
                       device=device).mul_(std)


def make_weights(torch, arch: dict, seed: int, device) -> Dict[str, object]:
    """path -> tensor in the configuration's dtype, on ``device``."""
    dtype = getattr(torch, arch["dtype"])
    return {leaf[0]: draw_leaf(torch, leaf, seed, device, dtype)
            for leaf in layout(arch)}


def as_tree(weights: Dict[str, object], specs) -> dict:
    """The flat weights as the program's nested tree of ``specs`` (a dict
    tree whose leaves have ``.shape``): every path present, every shape
    equal, nothing left over."""
    left = dict(weights)

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in node.items()}
        if prefix not in left:
            raise KeyError(f"the program has a leaf {prefix!r} the "
                           f"configuration's layout lacks")
        t = left.pop(prefix)
        if tuple(t.shape) != tuple(node.shape):
            raise ValueError(f"{prefix}: program shape {tuple(node.shape)}, "
                             f"layout {tuple(t.shape)}")
        return t
    tree = walk(specs, "")
    if left:
        raise KeyError(f"leaves the program does not have: {sorted(left)}")
    return tree


#: elements of each leaf whose first gradient is compared one by one
SAMPLE = 1 << 16


def sample_index(torch, seed: int, path: str, numel: int):
    """The flat indices of leaf ``path`` whose values are compared, drawn
    from the seed (every index when the leaf is small): a CPU tensor."""
    if numel <= SAMPLE:
        return torch.arange(numel)
    g = torch.Generator()
    g.manual_seed(sub_seed(seed, "sample/" + path))
    return torch.randint(0, numel, (SAMPLE,), generator=g)


class TokenFeed:
    """Batches of uniform tokens, one draw of (B, S + 1) per step from one
    generator on the device: step i's rows are the i-th draw, new rows
    every step.  ``tokens`` are the first S, ``targets`` the last S."""

    def __init__(self, torch, seed: int, batch: int, seq: int, vocab: int,
                 device):
        self.torch, self.shape, self.vocab = torch, (batch, seq + 1), vocab
        self.device = device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(sub_seed(seed, "tokens"))

    def next(self) -> dict:
        x = self.torch.randint(0, self.vocab, self.shape, generator=self.gen,
                               device=self.device)
        return {"tokens": x[:, :-1], "targets": x[:, 1:]}
