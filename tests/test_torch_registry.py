"""The port's backend registry and config against the reference's
(``tests/test_registry.py::test_third_party_backend_registers_and_dispatches``),
on the CPU: a backend registered under a name outside the ``Backend`` enum
builds a config, resolves for a request and dispatches through ``dense()``
in both packages; a params object of the wrong class is refused."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ApproxConfig as JApprox
from repro.configs.base import Backend as JBackend
from repro.configs.base import TrainMode as JMode
from repro.core import registry as jregistry
from repro.core.approx_linear import ApproxCtx as JCtx
from repro.core.approx_linear import dense as j_dense
from repro.runtime.engine import Request as JRequest
from repro.runtime.engine import resolve_approx as j_resolve
from repro_torch.configs.base import ApproxConfig, Backend, SCParams, TrainMode
from repro_torch.core import registry
from repro_torch.core.approx_linear import ApproxCtx, dense
from repro_torch.runtime.engine import Request, resolve_approx

NAME = "halfrate"


@dataclasses.dataclass(frozen=True)
class HalfParams:
    scale: float = 0.5


@pytest.fixture
def halfrate():
    """A backend registered from outside core, in both packages, under a
    name the enum has never heard of; removed again afterwards."""
    registry.register(registry.BackendSpec(
        name=NAME, params_cls=HalfParams, emulate=lambda x, w, p, rng: (x @ w) * p.scale,
    ))
    jregistry.register(jregistry.BackendSpec(
        name=NAME, params_cls=HalfParams, emulate=lambda x, w, p, rng: (x @ w) * p.scale,
        proxy_forward=lambda x, w, p: (x @ w) * p.scale, calib_degree=1,
    ))
    try:
        yield
    finally:
        registry._REGISTRY.pop(NAME, None)
        jregistry._REGISTRY.pop(NAME, None)
    assert NAME not in registry.names()


def test_third_party_backend_registers_and_dispatches(halfrate):
    """The reference's extensibility check on the port: the config takes the
    name, defaults its params from the spec's class, a request resolves to
    it, and dense() dispatches to it on the CPU, equal to the reference's
    dense() on the same inputs."""
    cfg = ApproxConfig(backend=Backend.EXACT, mode=TrainMode.MODEL,
                       site_backends=(("attn_*", NAME),))
    jcfg = JApprox(backend=JBackend.EXACT, mode=JMode.MODEL, site_backends=(("attn_*", NAME),))
    assert cfg.backend_for("attn_q") == NAME == jcfg.backend_for("attn_q")
    assert cfg.backend_for("mlp_up") == Backend.EXACT
    assert isinstance(cfg.params_for(NAME), HalfParams)
    assert cfg.approx_backends == (NAME,) == jcfg.approx_backends
    assert cfg.active

    lane = resolve_approx(Request(rid=0, prompt=(1, 2), backend=NAME), ApproxConfig())
    jlane = j_resolve(JRequest(rid=0, prompt=(1, 2), backend=NAME), JApprox())
    assert lane.backend == NAME == jlane.backend
    assert lane.mode == TrainMode.MODEL and lane.active

    rnd = np.random.default_rng(0)
    x = (rnd.standard_normal((4, 8)) * 0.4).astype(np.float32)
    w = (rnd.standard_normal((8, 4)) * 0.4).astype(np.float32)
    got = dense(torch.from_numpy(x), torch.from_numpy(w), site="attn_q",
                ctx=ApproxCtx(cfg=cfg)).numpy()
    want = np.asarray(j_dense(jnp.asarray(x), jnp.asarray(w), site="attn_q",
                              ctx=JCtx(cfg=jcfg, rng=jax.random.PRNGKey(0))))
    np.testing.assert_allclose(got, (x @ w) * 0.5, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # the same name as a request's default backend, through dense()
    got = dense(torch.from_numpy(x), torch.from_numpy(w), site="mlp_up",
                ctx=ApproxCtx(cfg=lane)).numpy()
    np.testing.assert_allclose(got, (x @ w) * 0.5, rtol=1e-6)


def test_unregistered_names_are_refused():
    """An unknown backend name fails when the config is made or the request
    resolved, as in the reference, not mid-forward."""
    with pytest.raises(ValueError, match="nosuch"):
        ApproxConfig(site_backends=(("attn_*", "nosuch"),))
    with pytest.raises(ValueError, match="nosuch"):
        JApprox(site_backends=(("attn_*", "nosuch"),))
    with pytest.raises(KeyError, match="nosuch"):
        resolve_approx(Request(rid=0, prompt=(1,), backend="nosuch"), ApproxConfig())
    with pytest.raises(KeyError, match="nosuch"):
        j_resolve(JRequest(rid=0, prompt=(1,), backend="nosuch"), JApprox())


@pytest.mark.parametrize("field", ["sc", "approx_mult", "analog", "log_mult"])
def test_wrong_params_class_raises(field):
    """``ApproxConfig(sc=3)`` and the like raise TypeError, as the reference's
    config does; the right class is accepted."""
    with pytest.raises(TypeError, match=field):
        ApproxConfig(**{field: 3})
    with pytest.raises(TypeError, match=field):
        JApprox(**{field: 3})
    with pytest.raises(TypeError, match=field):
        ApproxConfig(**{field: SCParams() if field != "sc" else HalfParams()})
    assert ApproxConfig(sc=SCParams(bits=64)).params_for("sc").bits == 64
