"""Multi-device forms of the PyTorch port on ``torch.distributed``: the
(dp, mp) engine mesh, the sharded, spatial and Schur BA steps, and the
dry-run entry points."""
