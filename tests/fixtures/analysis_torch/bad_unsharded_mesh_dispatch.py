"""Seeded violation (torch twin of ``bad_unsharded_mesh_dispatch.py``):
the mesh dispatch site fed shapes not drawn from a declared bucket — a
raw ``len(...)`` batch width and raw memo counts."""

from comdb2_tpu_torch.checker import linear_torch as LT


def check_mesh(mesh, memo, succ, sb, histories):
    return LT.check_device_keys_sharded(   # <- unbucketed-dispatch-site
        mesh, succ, sb.inv_proc, sb.inv_tr, sb.ok_proc, sb.depth,
        B=len(histories), F=128, P=4,
        n_states=memo.n_states, n_transitions=memo.n_transitions)
