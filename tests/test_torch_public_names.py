"""The port's public names against the JAX package's, and the default
device of its public constructors:

* every public name each package __init__.py of the JAX package binds
  (top level, codecs, ops, parallel, utils) is bound by the port's
  counterpart (the port's own extra names are allowed);
* codecs.jp2.Jp2Image, like every other public constructor, runs on the
  card unless asked for the CPU: without a card its default raises, and
  device="cpu" decodes planes equal to the JAX package's."""

import ast
import importlib

import numpy as np
import pytest
import torch

PACKAGES = ["", ".codecs", ".ops", ".parallel", ".utils"]


def _public(mod) -> set:
    """The public names the package's __init__.py binds (imports,
    assignments, definitions), read from its source: submodules that
    other code imported later are attributes of the package too, but not
    names its __init__ exports."""
    with open(mod.__file__) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "top")
def test_public_names_cover_jax(sub):
    jax_mod = importlib.import_module("lilliput_tpu" + sub)
    port = importlib.import_module("lilliput_tpu_torch" + sub)
    missing = sorted(_public(jax_mod) - _public(port))
    assert not missing, f"lilliput_tpu_torch{sub} lacks {missing}"


def test_avif_option_keys_equal_jax():
    import lilliput_tpu as L
    import lilliput_tpu_torch as T
    assert (T.AVIF_QUALITY, T.AVIF_SPEED) == (L.AVIF_QUALITY, L.AVIF_SPEED)


def test_ops_submodules_are_the_ports():
    import lilliput_tpu_torch.ops as TO
    for name in ("blend", "orient", "resize"):
        assert getattr(TO, name).__name__ == f"lilliput_tpu_torch.ops.{name}"


def _jp2() -> bytes:
    from lilliput_tpu.codecs import jp2_enc as JE
    img = np.random.default_rng(5).integers(0, 256, (21, 17, 3), np.uint8)
    return JE.encode_jp2(img)


def test_jp2image_default_device_is_the_card():
    from lilliput_tpu_torch.codecs import jp2 as TD
    b = _jp2()
    if torch.cuda.is_available():
        assert TD.Jp2Image(b).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TD.Jp2Image(b)
    img = TD.Jp2Image(b, device="cpu")
    assert img.device == torch.device("cpu")


def test_jp2image_cpu_planes_equal_jax():
    from lilliput_tpu.codecs import jp2 as JD
    from lilliput_tpu_torch.codecs import jp2 as TD
    b = _jp2()
    for p, q in zip(TD.Jp2Image(b, device="cpu").decode(),
                    JD.Jp2Image(b).decode()):
        np.testing.assert_array_equal(p.numpy(), np.asarray(q))
