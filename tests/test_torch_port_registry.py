"""The port's ``Registry`` against the reference's, and the port's model
registrations.

- Registration by decorator and by direct call, with metadata, the
  ``_3d`` suffix fallback, ``suffix=`` registration, ``in``, iteration
  and ``keys``, and ``KeyError`` on a duplicate and on a miss, with the
  reference's messages word for word.
- The five registries carry the reference's names.
- ``MODEL_REGISTRY`` holds the reference's model names, and the metadata
  of each: ``embed_length`` (for every encoder at several widths) and
  ``reads_point_coords``.
- Every config's model and encoder resolve to the same ``embed_length``
  in both packages, and ``build_model`` and the encoder lookup raise the
  reference's ``KeyError`` for a name the registry does not hold.
"""

import dataclasses
import glob
import os

import pytest

import tdwss.models  # noqa: F401  (registers the reference's models)
import tdwss_torch.models.kpconv.architectures  # noqa: F401
from tdwss import registry as ref_registry
from tdwss.config import load_config as ref_load_config
from tdwss.models.sparse_encoders import embed_length_of as ref_embed_length
from tdwss_torch import registry
from tdwss_torch.config import load_config
from tdwss_torch.models import meta_arch
from tdwss_torch.models.sparse_encoders import (embed_length_of,
                                                encoder_names, output_width,
                                                plane_schedule)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def _error(fn):
    with pytest.raises(KeyError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("pkg", [ref_registry, registry],
                         ids=["reference", "port"])
def test_registry_semantics(pkg):
    reg = pkg.Registry("thing")
    assert reg.name == "thing"

    @reg.register(width=lambda m: 2 * m)
    class Alpha:
        pass

    def beta():
        return 1

    assert reg.register(beta) is beta
    reg.register(suffix="3d", tag=1)(type("Gamma", (), {}))
    assert reg.get("Alpha")[0] is Alpha
    assert reg.get("Alpha")[1]["width"](3) == 6
    assert reg.get("beta") == (beta, {})
    gamma, meta = reg.get("Gamma")              # the _3d fallback
    assert gamma.__name__ == "Gamma" and meta == {"tag": 1}
    assert "Gamma_3d" in reg and "Gamma" not in reg
    assert list(reg.keys()) == ["Alpha", "beta", "Gamma_3d"]
    assert [k for k, _ in reg] == ["Alpha", "beta", "Gamma_3d"]


def test_registry_errors_word_for_word():
    msgs = []
    for pkg in (ref_registry, registry):
        reg = pkg.Registry("thing")
        reg.register(type("Alpha", (), {}))
        msgs.append((
            _error(lambda: reg.register(type("Alpha", (), {}))),
            _error(lambda: reg.get("Missing")),
            _error(lambda: reg.get("Alpha", suffix="2d") and reg.get("B"))))
    assert msgs[0] == msgs[1]
    assert "already registered in 'thing' registry" in msgs[1][0]


def test_five_registries():
    names = ("DATASET_REGISTRY", "ARCH_REGISTRY", "MODEL_REGISTRY",
             "LOSS_REGISTRY", "METRIC_REGISTRY")
    for n in names:
        assert getattr(registry, n).name == getattr(ref_registry, n).name


def test_model_registry_holds_the_reference_names_and_metadata():
    ref = {k: v for k, v in ref_registry.MODEL_REGISTRY}
    port = {k: v for k, v in registry.MODEL_REGISTRY}
    assert set(port) == set(ref)
    for name, (_, meta) in ref.items():
        pmeta = port[name][1]
        assert set(pmeta) == set(meta), name
        if "reads_point_coords" in meta:
            assert pmeta["reads_point_coords"] == meta["reads_point_coords"]
        for m in (4, 16, 32, 48):
            if "embed_length" in meta:
                assert pmeta["embed_length"](m) == meta["embed_length"](m)
    assert set(encoder_names()) == {
        n for n in ref if n.startswith("SparseConv")}
    assert meta_arch.model_reads("FullySupervised") == (True, True)
    assert meta_arch.model_reads("MultiLabel") == (False, False)
    assert meta_arch.model_reads("SparseConvUNet") == (True, True)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_model_resolves_to_the_same_embed_length(path):
    cfg, ref = load_config(path), ref_load_config(path)
    pc = cfg.pointcloud_model
    assert embed_length_of(pc.name, pc.m) == ref_embed_length(
        ref.pointcloud_model.name, ref.pointcloud_model.m)
    cls, _ = registry.MODEL_REGISTRY.get(cfg.model_name)
    ref_cls, _ = ref_registry.MODEL_REGISTRY.get(ref.model_name)
    assert cls.__name__ == ref_cls.__name__
    assert len(plane_schedule(pc)) >= 3 and output_width(pc) > 0
    if cfg.has_text:
        tcls, _ = registry.MODEL_REGISTRY.get(cfg.text_model.name)
        assert tcls.__name__ == cfg.text_model.name


def test_unknown_names_raise_the_reference_key_error():
    cfg = load_config(CONFIGS[0])
    ref = ref_load_config(CONFIGS[0])
    bad = dataclasses.replace(cfg, model_name="NoSuchModel")
    ref_bad = dataclasses.replace(ref, model_name="NoSuchModel")
    from tdwss.models import build_model as ref_build_model

    msg = _error(lambda: meta_arch.build_model(bad, device="cpu"))
    assert msg == _error(lambda: ref_build_model(ref_bad))
    pc = dataclasses.replace(cfg.pointcloud_model, name="NoSuchEncoder")
    assert _error(lambda: plane_schedule(pc)) == _error(
        lambda: ref_registry.MODEL_REGISTRY.get("NoSuchEncoder"))
    assert "is not a point-cloud encoder" in _error(lambda: plane_schedule(
        dataclasses.replace(pc, name="MultiLabel")))
