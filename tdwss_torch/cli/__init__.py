"""Command-line entry points of the weak-supervision loop (twins of
``tdwss.cli``): ``python -m tdwss_torch.cli.<name> --config <yaml>``."""
