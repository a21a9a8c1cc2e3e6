"""The L-TAE's route follows ``use_pallas`` / ``use_pallas_train`` as in the
JAX package (crop2seg_tpu/nn/ltae.py:471-485, models/timeunet.py:89-92):
for every combination of the two flags, ``seq_chunk`` and train / eval, the
port's TimeUNet and U-TAE reach the route the JAX module reaches, recorded
by patching the JAX ``LTAE._fused`` / ``_fused_train`` / ``_chunked`` and the
port's ``_fused`` / ``_train`` / ``_chunked`` to raise (the plain ops
otherwise); the port runs ``fused=True`` on the CPU, where the kernel
routes call the wrappers' plain versions. TimeUNet defers in_conv's tail
exactly on the two kernel routes. The port CLI resolves ``--use_pallas``
as the JAX CLI's ``resolve_use_pallas`` does, and its config for
``--model timeunet --seq_chunk 8`` without ``--use_pallas_train`` trains
the L-TAE through ``_chunked`` on the card, as the JAX CLI's model does.
"""
import importlib.util
import os
import types

import jax
import numpy as np
import pytest
import torch

from crop2seg_tpu.models import TimeUNet as JTimeUNet
from crop2seg_tpu.models import UTAE as JUTAE
from crop2seg_tpu.models.factory import get_model as jget_model
from crop2seg_tpu.nn.ltae import LTAE as JLTAE
from crop2seg_tpu_torch import train as cli
from crop2seg_tpu_torch.models import UTAE, TimeUNet
from crop2seg_tpu_torch.models.factory import get_model, resolve_use_pallas

KW = dict(input_dim=4, encoder_widths=(8, 8), decoder_widths=(8, 8), out_conv=(8, 5),
          n_head=2, d_model=16, d_k=4)
JAX_ROUTES = {"_fused": "eval", "_fused_train": "pair", "_chunked": "chunked"}
PORT_ROUTES = {"_fused": "eval", "_train": "pair", "_chunked": "chunked"}


class Routed(Exception):
    pass


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 5, 8, 8, 4)).astype(np.float32)
    dates = (np.arange(5, dtype=np.float32) * 7)[None]
    return x, dates, np.zeros((1, 5), bool)


def _raise(route):
    def stop(*args, **kwargs):
        raise Routed(route)
    return stop


_SHAPES = {}


def jax_route(model, train: bool, monkeypatch) -> str:
    """The route the JAX model's L-TAE takes in one apply, traced for shapes
    only (``jax.eval_shape``: nothing is compiled or run; the variables'
    shapes, which no flag changes, traced once a model class)."""
    x, dates, pad = _inputs()
    key = type(model)
    if key not in _SHAPES:
        _SHAPES[key] = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), x, dates, pad_mask=pad, train=False))
    v = _SHAPES[key]
    with monkeypatch.context() as mp:
        for name, route in JAX_ROUTES.items():
            mp.setattr(JLTAE, name, _raise(route))
        try:
            jax.eval_shape(lambda v: model.apply(
                v, x, dates, pad_mask=pad, train=train, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(1)}), v)
        except Routed as r:
            return r.args[0]
    return "plain"


def port_route(model, train: bool, monkeypatch) -> tuple:
    """The route the port model's L-TAE takes (``fused=True``), and whether
    in_conv handed it a deferred tail."""
    x, dates, pad = (torch.from_numpy(a) for a in _inputs())
    te, seen = model.temporal_encoder, {}

    def stop(route):
        def fn(*args, **kwargs):
            seen["tail"] = kwargs.get("tail_affine") is not None or any(
                isinstance(a, tuple) for a in args)
            raise Routed(route)
        return fn
    with monkeypatch.context() as mp:
        for name, route in PORT_ROUTES.items():
            mp.setattr(te, name, stop(route))
        try:
            model.train(train)(x, dates, pad, fused=True)
        except Routed as r:
            return r.args[0], seen["tail"]
    return "plain", False


FLAGS = [(p, pt) for p in (False, True) for pt in (False, True)]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("seq_chunk", [None, 2])
@pytest.mark.parametrize("use_pallas,use_pallas_train", FLAGS)
def test_timeunet_routes_follow_the_flags(use_pallas, use_pallas_train, seq_chunk, train,
                                          monkeypatch):
    flags = dict(use_pallas=use_pallas, use_pallas_train=use_pallas_train,
                 seq_chunk=seq_chunk)
    want = jax_route(JTimeUNet(**KW, **flags), train, monkeypatch)
    got, tail = port_route(TimeUNet(**KW, **flags), train, monkeypatch)
    assert got == want, (flags, train)
    assert tail == (got in ("eval", "pair")), (flags, train, tail)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("agg_mode", ["att_group", "mean"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_utae_routes_follow_use_pallas(use_pallas, agg_mode, train, monkeypatch):
    """U-TAE has ``use_pallas`` only (crop2seg_tpu/models/utae.py:55): the
    eval kernel in eval with it, the plain ops in training whatever the
    aggregation asks of the attention."""
    kw = dict(KW, agg_mode=agg_mode, use_pallas=use_pallas)
    want = jax_route(JUTAE(**kw), train, monkeypatch)
    got, _ = port_route(UTAE(**kw), train, monkeypatch)
    assert got == want, (kw, train)


class _JaxCli:
    """The JAX package's train.py, loaded from its file."""

    def __init__(self):
        path = os.path.join(os.path.dirname(__file__), "..", "train.py")
        spec = importlib.util.spec_from_file_location("c2s_train_cli_flags", path)
        self.mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(self.mod)


@pytest.fixture(scope="module")
def jcli():
    return _JaxCli().mod


@pytest.mark.parametrize("value", ["auto", "true", "false"])
def test_cli_resolves_use_pallas_as_the_jax_cli(jcli, value):
    """``--use_pallas`` on the CPU and on the card (the JAX CLI's TPU)."""
    for platform, device in (("cpu", "cpu"), ("tpu", "cuda")):
        want = jcli.resolve_use_pallas(types.SimpleNamespace(use_pallas=value,
                                                             platform=platform))
        config = cli.parse_config(["--use_pallas", value, "--device", device])
        assert resolve_use_pallas(value, device) is want
        assert cli.model_config(config, torch.device(device))["use_pallas"] is want


def test_cli_seq_chunk_trains_through_chunked_without_use_pallas_train(jcli, monkeypatch):
    """``--model timeunet --seq_chunk 8`` on the card without
    ``--use_pallas_train``: the L-TAE's pair is off and seq_chunk 8 on, so
    training streams T through ``_chunked`` (and eval runs the eval kernel),
    as the JAX CLI's model on the TPU does; with the flag the pair trains."""
    argv = ["--model", "timeunet", "--seq_chunk", "8", "--encoder_widths", "[8,8]",
            "--decoder_widths", "[8,8]", "--out_conv", "[8,5]", "--n_head", "2",
            "--d_model", "16", "--input_dim", "4"]
    for extra, train_route in (([], "chunked"), (["--use_pallas_train"], "pair")):
        config = cli.parse_config(argv + extra)
        cfg = cli.model_config(config, torch.device("cuda"))
        te = get_model(cfg, device="cpu").temporal_encoder
        assert te.seq_chunk == 8 and te.use_pallas_train is bool(extra)
        assert te.train().route(need_attn=False) == train_route
        assert te.eval().route(need_attn=False) == "eval"
        jconfig = jcli.parse_config(argv + extra + ["--platform", "tpu"])
        jcfg = dict(vars(jconfig), use_pallas=jcli.resolve_use_pallas(jconfig))
        jm = jget_model(jcfg)
        assert jm.seq_chunk == 8 and jm.use_pallas_train is bool(extra)
        assert jax_route(jm, True, monkeypatch) == train_route
        assert jax_route(jm, False, monkeypatch) == "eval"
