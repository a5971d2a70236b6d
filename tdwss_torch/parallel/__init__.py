"""Data-parallel training over ``torch.distributed`` (twin of
:mod:`tdwss.parallel`): :mod:`tdwss_torch.parallel.dp`."""
