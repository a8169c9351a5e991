"""The sharded tile-row pipelines over several ranks (``torch.distributed``):
the port of the reference's ``encoder/rd.py rd_gop_rows_sharded`` and
``rd_p_rows_sharded`` and of ``__graft_entry__.py dryrun_multichip``.

  mesh.py     the (frame, row) mesh of ranks, their backend and devices,
              and the launcher (one process per rank)
  halo.py     the recon halo exchange between row neighbours
  sharded.py  rd_p_rows_sharded, rd_gop_rows_sharded
  dryrun.py   dryrun_multichip (``python -m h264_tpu_torch.parallel.dryrun``)
"""
