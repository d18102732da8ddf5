"""Counterpart of ``tensorflowonspark_tpu/compat.py`` (maps reference
compat.py:1-31).

The JAX module shims JAX API locations that moved across releases
(``tree_map``, ``shard_map``, ``make_mesh``); PyTorch has nothing of theirs
to shim.  What it holds beyond JAX is `export_chief_only`.
"""


def export_chief_only(save_fn, is_chief, *args, **kwargs):
    """Run a model-export function on the chief only (reference: compat.py:10-17).

    The reference had non-chief workers save to a throwaway local dir because
    MultiWorkerMirroredStrategy required symmetric saves; the port has no
    such requirement, so non-chief is a no-op.
    """
    if is_chief:
        return save_fn(*args, **kwargs)
    return None
