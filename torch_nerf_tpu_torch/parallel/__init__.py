"""Multi-rank parallelism on ``torch.distributed``: the counterpart of
``torch_nerf_tpu/parallel/`` (the mesh, the layouts, the sharded train
steps and render, the sample-axis composite, scenes over ranks)."""
