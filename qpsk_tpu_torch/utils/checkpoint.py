"""Checkpoint / resume for modem state (port of
``qpsk_tpu.utils.checkpoint``).

A state tuple is flattened to its tensors in the JAX package's leaf order
(``state.flatten``: what ``jax.tree.leaves`` gives for the same state) and
written as ``leaf_0 .. leaf_{n-1}`` of a dependency-free ``.npz``, so a
checkpoint written by either package loads into the other.  ``load_state``
checks the leaf count and every leaf's shape against ``like`` and places
each leaf on ``like``'s device with its dtype.
"""

from __future__ import annotations

import numpy as np

from qpsk_tpu_torch.state import flatten, unflatten


def savez_exact(path, **arrays) -> None:
    """``np.savez`` that writes to ``path`` verbatim: ``np.savez`` appends
    '.npz' to a string path without that suffix, so a checkpoint saved as
    ``foo.state`` would land at ``foo.state.npz``.  Writing through an open
    file suppresses the suffix; a file-like ``path`` passes straight
    through."""
    if hasattr(path, "write"):
        np.savez(path, **arrays)
    else:
        with open(path, "wb") as fh:
            np.savez(fh, **arrays)


def save_state(path, state) -> None:
    """Serialize a modem state tuple to an .npz file; the leaves are
    copied to the host.  ``treedef`` records the tuple's structure as
    text, read only to explain a mismatch on load."""
    leaves = flatten(state)
    arrays = {f"leaf_{i}": leaf.detach().cpu().numpy()
              for i, leaf in enumerate(leaves)}
    savez_exact(path, treedef=np.frombuffer(
        _structure(state).encode(), dtype=np.uint8), **arrays)


def load_state(path, like):
    """Restore a state saved by ``save_state`` (of either package) into
    the structure of ``like``, each leaf on the device and of the dtype of
    ``like``'s.  Raises ``ValueError`` if the saved leaves do not line up
    with ``like`` (count or shape)."""
    data = np.load(path)
    leaves_like = flatten(like)
    nsaved = sum(1 for k in data.files if k.startswith("leaf_"))
    if nsaved != len(leaves_like):
        saved_def = bytes(data["treedef"]).decode()
        raise ValueError(
            f"checkpoint structure mismatch: holds {nsaved} leaves, "
            f"'like' has {len(leaves_like)}\n  saved treedef: {saved_def}\n"
            f"  expected: {_structure(like)}")
    for i, ref in enumerate(leaves_like):
        saved_shape = tuple(data[f"leaf_{i}"].shape)
        if saved_shape != tuple(ref.shape):
            raise ValueError(
                f"checkpoint structure mismatch at leaf {i}: saved shape "
                f"{saved_shape}, 'like' has {tuple(ref.shape)}")
    return unflatten(like, [data[f"leaf_{i}"]
                            for i in range(len(leaves_like))])


def _structure(tree) -> str:
    """A readable form of a state tuple's structure."""
    if tree is None:
        return "None"
    if isinstance(tree, tuple):
        inner = ", ".join(_structure(v) for v in tree)
        name = type(tree).__name__ if hasattr(tree, "_fields") else ""
        return f"{name}({inner})"
    return f"*{tuple(tree.shape)}"
