"""Port parity: the serving export (aas_enhancement_tpu_torch.serving, on
``torch.export``) and the kernels' operators (.ops.library) against the JAX
package and the plain versions, on the CPU.

Small widths as ``tests/test_serving.py`` (one conv layer of 8 channels,
BiLSTM-16), weights carried across from the flax parameters by
``convert.py``.  Tolerances: the artifact against the port's live path
exactly (the same operators on the same inputs); against the JAX
``ServedEnhancer`` and ``make_enhance_fn`` 1e-4 absolute,
``tests/test_torch_enhancer.py``'s limit for the enhance path (STFT,
enhancer and ISTFT sums in two frameworks); each operator on the CPU bit
for bit its plain version.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aas_enhancement_tpu.config import Config, EnhancerConfig
from aas_enhancement_tpu.enhance import init_enhancer as jax_init_enhancer
from aas_enhancement_tpu.enhance import make_enhance_fn as jax_make_enhance_fn
from aas_enhancement_tpu.serving import export_enhancer as jax_export_enhancer
from aas_enhancement_tpu.serving import load_enhancer as jax_load_enhancer
from aas_enhancement_tpu_torch.cli import export as export_cli
from aas_enhancement_tpu_torch.config import Config as TConfig
from aas_enhancement_tpu_torch.convert import enhancer_params_from_flax
from aas_enhancement_tpu_torch.enhance import make_enhance_fn
from aas_enhancement_tpu_torch.models.enhancer import Enhancer
from aas_enhancement_tpu_torch.ops import library
from aas_enhancement_tpu_torch.ops.cuda import gn, rnn
from aas_enhancement_tpu_torch.ops.cuda import stft as kstft
from aas_enhancement_tpu_torch.serving import export_enhancer, load_enhancer
from aas_enhancement_tpu_torch.train.loop import init_state
from aas_enhancement_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = Config(enhancer=EnhancerConfig(conv_channels=8, conv_layers=1, rnn_hidden=16,
                                     rnn_layers=1))
TCFG = TConfig.from_json(CFG.to_json())
F_BINS = 161
JAX_ATOL = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(flax params, the converted torch Enhancer, the port's artifact dir,
    its manifest)."""
    params = jax_init_enhancer(CFG, jax.random.key(0))
    model = Enhancer(TCFG.enhancer, F_BINS)
    model.load_state_dict(enhancer_params_from_flax(params))
    model.eval()
    out = str(tmp_path_factory.mktemp("serving"))
    manifest = export_enhancer(TCFG, model, out, batch_sizes=(1, 2), seconds=(0.5, 1.0),
                               device="cpu")
    return params, model, out, manifest


def _live(model, wav, lengths):
    return make_enhance_fn(TCFG, "cpu")(model, torch.from_numpy(wav),
                                        torch.from_numpy(lengths)).numpy()


def test_manifest_written(setup):
    _, _, out, manifest = setup
    assert len(manifest["entries"]) == 4
    assert manifest["sample_rate"] == 16000
    assert manifest["kind"] == "aas_enhancement_tpu.enhancer"
    assert manifest["config"] == json.loads(TCFG.to_json())
    assert all(e["platforms"] == ["cpu"] for e in manifest["entries"])
    served = load_enhancer(out, "cpu")
    assert served.buckets() == [(1, 8000), (1, 16000), (2, 8000), (2, 16000)]


def test_roundtrip_matches_live_path(setup):
    _, model, out, _ = setup
    served = load_enhancer(out, "cpu")
    wav = np.random.default_rng(0).standard_normal((2, 16000)).astype(np.float32) * 0.1
    lengths = np.array([16000, 12000], np.int64)
    exported = served.enhance(wav, lengths)
    assert exported.shape == wav.shape
    np.testing.assert_array_equal(exported, _live(model, wav, lengths))


def test_bucket_padding_dispatch(setup):
    """A (1, 10000) input runs in the smallest covering bucket (1, 16000) and
    equals the live path run at that padded shape, stripped back."""
    _, model, out, _ = setup
    served = load_enhancer(out, "cpu")
    wav = np.random.default_rng(1).standard_normal(10000).astype(np.float32) * 0.1
    exported = served.enhance(wav)
    pad = np.zeros((1, 16000), np.float32)
    pad[0, :10000] = wav
    live = _live(model, pad, np.array([10000], np.int64))[0, :10000]
    np.testing.assert_array_equal(exported[0], live)


def test_uncovered_shape_rejected(setup):
    _, _, out, _ = setup
    served = load_enhancer(out, "cpu")
    with pytest.raises(ValueError, match="no exported bucket"):
        served.enhance(np.zeros((4, 8000), np.float32))
    with pytest.raises(ValueError, match="no exported bucket"):
        served.enhance(np.zeros((1, 20000), np.float32))


def test_artifact_needs_no_params(setup):
    """The saved programs hold the weights: two loads give the same output."""
    _, _, out, _ = setup
    wav = np.random.default_rng(2).standard_normal((1, 8000)).astype(np.float32)
    a = load_enhancer(out, "cpu").enhance(wav)
    b = load_enhancer(out, "cpu").enhance(wav)
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all()


def test_artifact_matches_the_jax_artifact(setup, tmp_path):
    """The port's artifact against the JAX ``ServedEnhancer`` and
    ``make_enhance_fn`` on the same weights, ragged lengths."""
    params, _, out, _ = setup
    jax_export_enhancer(CFG, params, str(tmp_path), batch_sizes=(2,), seconds=(1.0,))
    wav = np.random.default_rng(3).standard_normal((2, 16000)).astype(np.float32) * 0.1
    lengths = np.array([16000, 9000], np.int32)
    wav[1, 9000:] = 0.0
    got = load_enhancer(out, "cpu").enhance(wav, lengths)
    ref = jax_load_enhancer(str(tmp_path)).enhance(wav, lengths)
    live = np.asarray(jax_make_enhance_fn(CFG)(params, jnp.asarray(wav), jnp.asarray(lengths)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=JAX_ATOL)
    np.testing.assert_allclose(got, live, rtol=0, atol=JAX_ATOL)


def test_exported_graph_calls_the_operators(setup):
    """Each kernel of the enhance path is one node of the saved graph."""
    _, _, out, manifest = setup
    entry = manifest["entries"][0]
    program = torch.export.load(os.path.join(out, entry["file"]))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    ours = sorted(t for t in targets if t.startswith(f"{library.NAMESPACE}."))
    assert ours == ["aas_torch.istft.default", "aas_torch.lstm_scan_tm.default",
                    "aas_torch.masked_group_norm_act.default", "aas_torch.stft.default"]


def test_artifact_loads_in_a_fresh_process_without_model_code(setup):
    """A new interpreter loads and runs the artifact from the directory
    alone: no checkpoint, and neither ``models/`` nor ``train/`` imported."""
    _, model, out, _ = setup
    script = (
        "import json, sys\n"
        "import numpy as np\n"
        "import torch\n"
        "from aas_enhancement_tpu_torch.serving import load_enhancer\n"
        "torch.set_num_threads(1)\n"
        f"served = load_enhancer({out!r}, 'cpu')\n"
        "wav = np.random.default_rng(4).standard_normal((2, 8000)).astype(np.float32) * 0.1\n"
        "y = served.enhance(wav)\n"
        "bad = [m for m in sys.modules if m.startswith(('aas_enhancement_tpu_torch.models',"
        " 'aas_enhancement_tpu_torch.train', 'jax', 'aas_enhancement_tpu.'))]\n"
        "print(json.dumps({'y': y.tolist(), 'bad': bad}))\n")
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=240, cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT})
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["bad"] == []
    wav = np.random.default_rng(4).standard_normal((2, 8000)).astype(np.float32) * 0.1
    np.testing.assert_array_equal(np.asarray(line["y"], np.float32),
                                  _live(model, wav, np.array([8000, 8000], np.int64)))


def test_export_cli(tmp_path, capsys):
    """``cli.export`` on a train-CLI directory: the JAX CLI's JSON line, and
    the JAX CLI's SystemExit for a checkpoint without an enhancer."""
    for objective in ("aas", "am"):
        cfg = TCFG.replace(train=dataclasses.replace(TCFG.train, objective=objective))
        d = tmp_path / objective
        d.mkdir()
        (d / "config.json").write_text(cfg.to_json())
        ckpt.save(str(d), 1, init_state(cfg, 0, "cpu"))
    out = str(tmp_path / "art")
    export_cli.main(["--checkpoint", str(tmp_path / "aas"), "--out", out, "--batch-sizes",
                     "1", "--seconds", "0.5", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"out": out, "entries": 1, "buckets": [[1, 8000]]}
    assert load_enhancer(out, "cpu").buckets() == [(1, 8000)]
    with pytest.raises(SystemExit, match="checkpoint has no enhancer"):
        export_cli.main(["--checkpoint", str(tmp_path / "am"), "--out", out,
                         "--device", "cpu"])


def test_artifact_device_is_checked(setup, monkeypatch):
    """The artifact and the export run on the card by default, raise without
    one, and never mix devices."""
    _, _, out, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="exported for \\['cpu'\\], not 'cuda'"):
        load_enhancer(out, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_enhancer(out)
    model = Enhancer(TCFG.enhancer, F_BINS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_enhancer(TCFG, model, out)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_cli.main(["--checkpoint", out, "--out", out])
    with pytest.raises(ValueError, match="the model lives on \\['cpu'\\], not cuda"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        export_enhancer(TCFG, model, out, device="cuda")


# ----------------------------------------------------------------- the operators
def _op_cases():
    rng = np.random.default_rng(5)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    x = t(2, 4000) * 0.3
    re, im = kstft.stft_plain(x, 320, 160)
    gates = t(9, 3, 2 * 4 * 16)
    ggru = t(9, 3, 2 * 3 * 16)
    m = (torch.arange(9)[:, None] < torch.tensor([9, 5, 0])[None]).float().contiguous()
    return {
        "stft": (library.stft, (x, 320, 160, "hann", True),
                 lambda: kstft.stft_plain(x, 320, 160, "hann", True)),
        "istft": (library.istft, (re, im, 320, 160, "hann", True, 3900),
                  lambda: kstft.istft_plain(re, im, 320, 160, "hann", True, 3900)),
        "masked_group_norm_act": (
            library.masked_group_norm_act,
            (t(2, 7, 5, 16), 1 + 0.1 * t(16), 0.1 * t(16), torch.tensor([7, 3]), 8, 1e-5,
             "leaky_relu", 0.2), None),
        "lstm_scan_tm": (library.lstm_scan_tm,
                         (gates[..., :64], gates[..., 64:], m, 0.3 * t(2, 16, 64),
                          0.1 * t(2, 64)), None),
        "gru_scan_tm": (library.gru_scan_tm,
                        (ggru[..., :48], ggru[..., 48:], m, 0.3 * t(2, 16, 48),
                         0.1 * t(2, 48)), None),
    }


@pytest.mark.parametrize("name", library.OPERATORS)
def test_operator_opcheck(name):
    """``torch.library.opcheck``: schema, fake (shape) implementation and
    autograd registration of each operator, on the CPU."""
    op, args, _ = _op_cases()[name]
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("name", library.OPERATORS)
def test_operator_is_the_plain_version_on_the_cpu(name):
    op, args, plain = _op_cases()[name]
    if plain is None:
        plain = {"masked_group_norm_act": lambda: gn.masked_group_norm_act_plain(
                     *args[:4], num_groups=args[4], eps=args[5], act=args[6], slope=args[7]),
                 "lstm_scan_tm": lambda: rnn.lstm_scan_tm_plain(*args),
                 "gru_scan_tm": lambda: rnn.gru_scan_tm_plain(*args)}[name]
    got, want = op(*args), plain()
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("name", library.OPERATORS)
def test_operator_fake_shapes_are_the_kernels(name):
    """The fake implementation's output shapes and dtypes equal the real
    ones'; under ``torch.export``'s fake tensors nothing reads data."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    op, args, _ = _op_cases()[name]
    real = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = op(*[mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args])
    for a, b in zip(real if isinstance(real, tuple) else (real,),
                    fake if isinstance(fake, tuple) else (fake,)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_wrappers_take_the_operators_without_a_gradient(monkeypatch):
    """The gradient-free branch of each wrapper calls its operator; a wanted
    gradient on the CPU still differentiates the plain version."""
    called = []
    cases = _op_cases()
    for name in library.OPERATORS:
        real = getattr(library, name)
        monkeypatch.setattr(library, name,
                            lambda *a, _n=name, _r=real: called.append(_n) or _r(*a))
    x, n_fft, hop, win, center = cases["stft"][1]
    kstft.stft(x, n_fft, hop, win, center)
    kstft.istft(*cases["istft"][1])
    xg, scale, bias, lengths, groups, eps, act, slope = cases["masked_group_norm_act"][1]
    gn.masked_group_norm_act(xg, scale, bias, lengths, num_groups=groups, eps=eps, act=act,
                             slope=slope)
    rnn.lstm_scan_tm(*cases["lstm_scan_tm"][1])
    rnn.gru_scan_tm(*cases["gru_scan_tm"][1])
    assert called == list(library.OPERATORS)
    called.clear()
    xr = x.clone().requires_grad_(True)
    re, im = kstft.stft(xr, n_fft, hop, win, center)
    (re.sum() + im.sum()).backward()
    assert called == [] and xr.grad is not None
