"""Geometric Selective Search (twin of :mod:`tdwss.gss`): proposals
(:mod:`tdwss_torch.gss.search`) and their evaluation and ensembling
(:mod:`tdwss_torch.gss.eval`)."""

from tdwss_torch.gss.search import (  # noqa: F401
    SimilarityMask,
    generate_proposals,
    hierarchical_segmentation,
    nms_3d,
    run_scene,
)
