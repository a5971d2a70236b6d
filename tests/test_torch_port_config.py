"""The port's config loader reads the repository's YAML experiment files
as the reference does, for every field the port keeps; every config
whose path is ported (MultiLabel or FullySupervised on scene-level,
pseudo or subcloud labels, MultiLabelContrastive with its text tower)
builds its model with the reference's plane schedule, head width and
text widths, and its first train batch (with its token rows for the
text configs); the CLIP config, which names no ``bpe_vocab_path``, is
refused with the reference's ``ValueError``; the encoder width table is
the reference registry's; the configs that ``chip_smoke.py`` builds in
code are the YAML files."""

import dataclasses
import glob
import os

import numpy as np
import pytest

from tdwss.config import load_config as ref_load_config
from tdwss.models import build_model as ref_build_model
from tdwss.models.sparse_encoders import embed_length_of as ref_embed_length
from tdwss.registry import MODEL_REGISTRY
from tdwss_torch.config import load_config, parse_yaml_subset
from tdwss_torch.data.collate import train_collate
from tdwss_torch.data.dataset import expand_subclouds
from tdwss_torch.data.synthetic import make_dataset
from tdwss_torch.models.meta_arch import build_model
from tdwss_torch.models.sparse_encoders import EMBED_LENGTH, embed_length_of

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def _same(port, ref, path="cfg"):
    for f in dataclasses.fields(port):
        pv, rv = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(pv):
            _same(pv, rv, f"{path}.{f.name}")
        else:
            assert pv == rv, f"{path}.{f.name}: {pv!r} != {rv!r}"


@pytest.mark.parametrize("name", ["3DUNetWithText_scannet_scene_level.yaml",
                                  "smoke_cpu.yaml"])
def test_load_config_matches_reference(name):
    path = os.path.join(REPO, "configs", name)
    assert path in CONFIGS
    _same(load_config(path, seed=3), ref_load_config(path, seed=3))




def _name(path):
    return os.path.basename(path)


@pytest.mark.parametrize("path", CONFIGS, ids=_name)
def test_every_config_loads_as_in_the_reference(path):
    _same(load_config(path), ref_load_config(path))


@pytest.mark.parametrize("path", CONFIGS, ids=_name)
def test_yaml_subset_reader_reads_every_config_as_pyyaml(path):
    """The port's only YAML reader (the card machine has no PyYAML)
    reads every config file as PyYAML does."""
    import yaml

    with open(path) as f:
        text = f.read()
    assert parse_yaml_subset(text) == yaml.safe_load(text)


def test_yaml_subset_reader_edge_cases():
    import yaml

    text = ("a:\nb:\n  c: [1, 2.5, x, -4]\n  d:\n"
            "  e: {f: 'q r', g: [true, null, ~]}\nh: -3 # comment\n"
            "# a comment line\ni: 1e-3\nj: 'a # b' # c\n"
            "k: \"x #y\"\nl: it's # c\nm: 'it''s'\nn: a#b\n")
    assert parse_yaml_subset(text) == yaml.safe_load(text)
    with pytest.raises(ValueError, match="unsupported"):
        parse_yaml_subset("a:\n  - 1\n")


def _runs_on_the_port(cfg):
    """Every config but the frozen CLIP tower's without the real CLIP
    vocabulary (the reference refuses it too)."""
    return not (cfg.has_text and cfg.text_model.name == "CLIPTransformer"
                and not cfg.text_data.bpe_vocab_path)


def _first_batch(cfg):
    """The config's first train batch (collate only) on synthetic scenes:
    subclouds under label ``subcloud``, seeded pseudo labels under
    ``pseudo``, descriptions under ``has_text``."""
    scenes = make_dataset(2, num_points=20000, seed=1,
                          with_text=cfg.has_text)
    if cfg.label == "subcloud":
        scenes = expand_subclouds(scenes, cfg.in_radius)[:2]
    if cfg.label == "pseudo":
        rng = np.random.default_rng(0)
        for s in scenes:
            s.pseudo_labels = rng.integers(
                0, 20, s.points.shape[0]).astype(np.int32)
            s.pseudo_labels[rng.random(s.points.shape[0]) < 0.1] = -100
    cfg.engine.max_points = 16384
    return train_collate(scenes, cfg, np.random.default_rng(0))


@pytest.mark.parametrize("path", CONFIGS, ids=_name)
def test_config_builds_its_model_or_names_what_is_missing(path):
    cfg = load_config(path)
    ref = ref_load_config(path)
    if _runs_on_the_port(cfg):
        model = build_model(cfg, device="cpu")
        pc = ref.pointcloud_model
        cls, _ = MODEL_REGISTRY.get(pc.name)
        kw = dict(m=pc.m, depth=pc.depth)
        if pc.n_planes is not None:
            kw["n_planes"] = tuple(pc.n_planes)
        planes = cls(**kw).plane_schedule()
        # the reference head (flax Dense) reads the encoder's real width
        width = {"unet": planes[0], "fcn": sum(planes),
                 "direct_uppool": planes[-1]}[cls.body_kind]
        assert model.linear.in_features == width
        assert model.pc_encoder.body_planes == tuple(planes)
        batch = _first_batch(cfg)
        assert batch.valid.sum() > 0
        assert batch.num_scenes == 2
        if cfg.label == "pseudo":
            labels = batch.point_label[batch.valid]
            assert (labels == -100).any() and (labels >= 0).any()
        if not cfg.has_text:
            assert batch.text is None
            return
        tm = ref.text_model
        tower = model.text_encoder
        assert (tower.width, tower.layers,
                tower.positional_embedding.shape[0],
                tower.token_embedding.num_embeddings) == (
            tm.width, tm.layers, tm.context_length, tm.vocab_size)
        embed = ref_embed_length(pc.name, pc.m)
        assert model.text_linear.in_features == tm.width
        assert model.text_linear.out_features == embed == width
        td = ref.text_data
        tokens = batch.text.tokens
        assert tokens.shape == (2, td.cropped_texts, td.max_seq_len)
        assert tokens.dtype == np.int32 and tokens.max() < tm.vocab_size
        assert batch.text.valid.all() and (tokens[:, 0] != 0).any(-1).all()
        return
    with pytest.raises(ValueError) as err:
        build_model(cfg, device="cpu")
    with pytest.raises(ValueError) as ref_err:
        ref_build_model(ref)
    head = "text_model.name=CLIPTransformer requires text_data.bpe_vocab_path"
    assert str(err.value).startswith(head)
    assert str(ref_err.value).startswith(head)


def test_only_the_text_configs_are_refused():
    """Of the text configs, only the frozen CLIP tower's (no
    ``bpe_vocab_path``) is refused; every other config runs."""
    refused = [p for p in CONFIGS if not _runs_on_the_port(load_config(p))]
    assert [os.path.basename(p) for p in refused] == [
        "3DUNetWithText_scannet_fcnet_CLIP.yaml"]
    text = [p for p in CONFIGS if load_config(p).has_text]
    assert len(text) == 6
    assert all(load_config(p).model_name == "MultiLabelContrastive"
               for p in text)
    labels = [load_config(p).label for p in CONFIGS
              if _runs_on_the_port(load_config(p))]
    assert labels.count("pseudo") == 2 and labels.count("subcloud") == 3


@pytest.mark.parametrize("name", sorted(EMBED_LENGTH))
def test_embed_length_table_is_the_registrys(name):
    for m in (4, 16, 32):
        assert embed_length_of(name, m) == ref_embed_length(name, m)


def test_chip_smoke_configs_are_the_yaml_files():
    import chip_smoke

    for fn, name in ((chip_smoke.narrow_config,
                      "3DUNetWithText_scannet_fcnet_baseline_narrower.yaml"),
                     (chip_smoke.fcnet_config,
                      "3DUNetWithText_scannet_fcnet_baseline_finer.yaml")):
        assert fn() == load_config(os.path.join(REPO, "configs", name))
