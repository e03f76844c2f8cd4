"""Seeded violation (torch twin of ``bad_vmap_sharded_route.py``):
production code routing mesh traffic onto the sharded TEST ORACLE
``linear_torch.check_sharded`` (the per-op engine split over a mesh);
serving traffic goes through ``checker.batch.check_batch``'s stream /
keys / flat sharded engines."""


def serve_batch(mesh, succ, batch):
    from comdb2_tpu_torch.checker.linear_torch import check_sharded

    return check_sharded(mesh, succ, batch.kind, batch.proc,   # <- vmap-sharded-oracle
                         batch.tr, F=256, P=4)
