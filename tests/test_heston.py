"""Heston model-family tests — extension beyond the reference (GBM-only).

Oracle chain: the semi-analytic characteristic-function price
(``heston_call_price``) is validated against the Black-Scholes limit
(xi → 0 reduces Heston to BS at the deterministic integrated variance),
then the MC simulator is gated against the oracle, then the trainer runs
end to end on a 10-dimensional Heston Sobol domain.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectralmc_tpu.core.result import Failure
from spectralmc_tpu.ops.analytic import black_scholes_price
from spectralmc_tpu.ops.gbm import ModelKind, PayoffKind, build_simulation_params
from spectralmc_tpu.ops.heston import (
    HESTON_CONTRACT_DIM,
    HestonContract,
    heston_call_price,
    heston_char_fn,
    heston_expected_underlier_mean,
    simulate_heston_underlier_rows,
    validate_heston_contract,
)
from spectralmc_tpu.ops.sobol import BoundSpec
from tests.helpers import expect_failure, expect_success

PARAMS = dict(
    spot=100.0, strike=100.0, maturity=1.0, rate=0.03, div_yield=0.01,
    v0=0.04, kappa=1.5, theta=0.04, xi=0.5, rho=-0.7,
)

HESTON_BOUNDS = {
    "spot": BoundSpec(lower=90.0, upper=110.0),
    "strike": BoundSpec(lower=90.0, upper=110.0),
    "maturity": BoundSpec(lower=0.5, upper=1.5),
    "rate": BoundSpec(lower=0.0, upper=0.05),
    "div_yield": BoundSpec(lower=0.0, upper=0.02),
    "v0": BoundSpec(lower=0.02, upper=0.09),
    "kappa": BoundSpec(lower=0.5, upper=3.0),
    "theta": BoundSpec(lower=0.02, upper=0.09),
    "xi": BoundSpec(lower=0.1, upper=0.8),
    "rho": BoundSpec(lower=-0.9, upper=0.0),
}


def test_contract_validation() -> None:
    good = HestonContract(**PARAMS)
    assert expect_success(validate_heston_contract(good)) is good
    bad = HestonContract(**{**PARAMS, "rho": 1.5})
    expect_failure(validate_heston_contract(bad))
    assert HESTON_CONTRACT_DIM == 10


def test_char_fn_basics() -> None:
    phi0 = heston_char_fn(np.array([0.0]), **{k: PARAMS[k] for k in PARAMS if k != "strike"})
    assert abs(phi0[0] - 1.0) < 1e-12  # phi(0) = 1
    # martingale: phi(-i) = E[S_T] = forward
    phi_mi = heston_char_fn(np.array([-1j]), **{k: PARAMS[k] for k in PARAMS if k != "strike"})
    fwd = PARAMS["spot"] * np.exp((PARAMS["rate"] - PARAMS["div_yield"]) * PARAMS["maturity"])
    assert abs(phi_mi[0].real - fwd) / fwd < 1e-10


def test_oracle_reduces_to_black_scholes_as_xi_vanishes() -> None:
    kappa, theta, v0, t = 2.0, 0.04, 0.09, 1.0
    int_var = theta * t + (v0 - theta) * (1 - np.exp(-kappa * t)) / kappa
    eff_vol = float(np.sqrt(int_var / t))
    call_h, put_h = heston_call_price(
        spot=100.0, strike=105.0, maturity=t, rate=0.03, div_yield=0.01,
        v0=v0, kappa=kappa, theta=theta, xi=1e-6, rho=0.0,
    )
    bs = black_scholes_price(
        jnp.float64(100.0), jnp.float64(105.0), jnp.float64(t),
        jnp.float64(0.03), jnp.float64(0.01), jnp.float64(eff_vol),
    )
    assert abs(call_h - float(bs.call)) < 5e-4
    assert abs(put_h - float(bs.put)) < 5e-4


def test_mc_matches_semianalytic_price() -> None:
    call_exact, put_exact = heston_call_price(**PARAMS)
    contract = HestonContract(**PARAMS)
    out = np.asarray(
        simulate_heston_underlier_rows(
            jax.random.PRNGKey(3), contract.as_array(jnp.float64),
            timesteps=64, rows=128, cols=1024, dtype=jnp.float64,
            payoff=PayoffKind.TERMINAL,
        )
    ).reshape(-1)
    df = np.exp(-PARAMS["rate"] * PARAMS["maturity"])
    calls = df * np.maximum(out - PARAMS["strike"], 0.0)
    se = calls.std() / np.sqrt(calls.size)
    z = (calls.mean() - call_exact) / se
    assert abs(z) < 4.0, f"MC {calls.mean():.4f} vs exact {call_exact:.4f}, z={z:.2f}"
    # martingale property of the discretization
    z_fwd = (out.mean() - float(heston_expected_underlier_mean(
        contract.as_array(jnp.float64), timesteps=64,
        payoff=PayoffKind.TERMINAL, dtype=jnp.float64,
    ))) / (out.std() / np.sqrt(out.size))
    assert abs(z_fwd) < 4.0


def test_shard_stable_row_offset() -> None:
    contract = HestonContract(**PARAMS).as_array(jnp.float32)
    key = jax.random.PRNGKey(9)
    kw = dict(timesteps=4, cols=128, dtype=jnp.float32, payoff=PayoffKind.TERMINAL)
    full = np.asarray(simulate_heston_underlier_rows(key, contract, rows=16, **kw))
    hi = np.asarray(simulate_heston_underlier_rows(key, contract, rows=8, row_offset=8, **kw))
    assert np.array_equal(hi, full[8:])


def test_geo_asian_mean_normalization_rejected() -> None:
    failure = build_simulation_params(
        mc_seed=1, timesteps=4, network_size=16, batches_per_mc_run=4,
        model=ModelKind.HESTON, payoff=PayoffKind.ASIAN_GEOMETRIC,
    )
    assert isinstance(failure, Failure)
    ok = build_simulation_params(
        mc_seed=1, timesteps=4, network_size=16, batches_per_mc_run=4,
        model=ModelKind.HESTON, payoff=PayoffKind.ASIAN_GEOMETRIC,
        normalization="none",
    )
    expect_success(ok)


def test_trainer_end_to_end_on_heston_domain() -> None:
    from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config
    from spectralmc_tpu.training.trainer import (
        GbmCVNNPricer,
        GbmCVNNPricerConfig,
        build_training_config,
    )

    sim = expect_success(
        build_simulation_params(
            mc_seed=5, timesteps=4, network_size=32, batches_per_mc_run=8,
            model=ModelKind.HESTON,
        )
    )
    cvnn = expect_success(
        build_cvnn_config(layers=[LinearCfg(width=24, activation=Activation.MODRELU)], seed=7)
    )
    cfg = GbmCVNNPricerConfig(sim=sim, bounds=HESTON_BOUNDS, cvnn=cvnn)
    pricer = expect_success(GbmCVNNPricer.create(cfg))
    tc = expect_success(build_training_config(num_batches=25, batch_size=8, learning_rate=2e-3))
    result = expect_success(pricer.train(tc))
    assert np.all(np.isfinite(result.losses))
    assert result.losses[-5:].mean() < result.losses[:5].mean()

    # snapshot/resume bit-exactness holds for the new family too
    snap = pricer.snapshot()
    a = expect_success(GbmCVNNPricer.create(snap))
    b = expect_success(GbmCVNNPricer.create(snap))
    tc2 = expect_success(build_training_config(num_batches=3, batch_size=4, learning_rate=1e-3))
    ra = expect_success(a.train(tc2))
    rb = expect_success(b.train(tc2))
    assert np.array_equal(ra.losses, rb.losses)

    # inference path: 10-field contracts in, finite prices out
    pred = a.predict_price([HestonContract(**PARAMS)])
    assert np.all(np.isfinite(pred.put)) and np.all(np.isfinite(pred.call))


def test_proto_roundtrip_with_model_kind() -> None:
    from spectralmc_tpu.serialization.converters import (
        sim_params_from_proto,
        sim_params_to_proto,
    )

    sim = expect_success(
        build_simulation_params(
            mc_seed=2, timesteps=4, network_size=16, batches_per_mc_run=4,
            model=ModelKind.HESTON, payoff=PayoffKind.ASIAN_ARITHMETIC,
        )
    )
    back = expect_success(sim_params_from_proto(sim_params_to_proto(sim)))
    assert back == sim and back.model == ModelKind.HESTON


def test_sharded_heston_matches_single_device() -> None:
    import math

    from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config, build_model
    from spectralmc_tpu.ops.sobol import SobolConfig, SobolSampler
    from spectralmc_tpu.parallel.mesh import build_mesh_spec
    from spectralmc_tpu.parallel.trainer import make_sharded_segment
    from spectralmc_tpu.training.step import SobolTable, make_fused_batch, make_optimizer

    sim = expect_success(
        build_simulation_params(
            mc_seed=3, timesteps=2, network_size=16, batches_per_mc_run=4,
            model=ModelKind.HESTON,
        )
    )
    cvnn = expect_success(
        build_cvnn_config(layers=[LinearCfg(width=16, activation=Activation.ZRELU)], seed=1)
    )
    model = expect_success(build_model(cvnn, input_dim=10, output_dim=sim.network_size))
    sampler = expect_success(
        SobolSampler.create(HestonContract, HESTON_BOUNDS, SobolConfig(seed=3))
    )
    dt = sampler.device_table()
    table = SobolTable(directions=dt["directions"], shift=dt["shift"],
                       lower=dt["lower"], upper=dt["upper"])
    params, bn = model.init()
    carry = {
        "params": params, "bn_state": bn,
        "opt_state": make_optimizer(1e-3).init(params),
        "sobol_skip": jnp.uint32(0), "mc_skip": jnp.uint32(0),
    }
    one = make_fused_batch(model, sim, table, batch_size=8, learning_rate=1e-3)
    ref_carry, (ref_loss, _) = jax.jit(
        lambda c: jax.lax.scan(one, c, None, length=3)
    )(carry)

    spec = expect_success(build_mesh_spec(batch_shards=4, paths_shards=2))
    run = make_sharded_segment(model, sim, table, batch_size=8, learning_rate=1e-3,
                               spec=spec, length=3)
    _, (sh_loss, _) = run(carry)
    rel = np.abs(np.asarray(sh_loss) - np.asarray(ref_loss)) / np.abs(np.asarray(ref_loss))
    assert rel.max() < 1e-4, f"sharded vs single-device loss diff {rel.max():.2e}"
    assert all(math.isfinite(float(x)) for x in np.asarray(sh_loss))


def test_heston_pallas_fallback_and_interpret() -> None:
    from spectralmc_tpu.ops.gbm_pallas import simulate_heston_underlier_rows_pallas
    from tests.helpers.kernels import zero_bits

    contract = HestonContract(**PARAMS).as_array(jnp.float32)
    key = jax.random.PRNGKey(5)
    kw = dict(timesteps=4, rows=8, cols=128, dtype=jnp.float32, payoff=PayoffKind.TERMINAL)
    # off the GPU without interpret=True the wrapper refuses instead of
    # silently running the XLA stream (resolve_implementation routes there)
    with pytest.raises(ValueError, match="resolve_implementation"):
        simulate_heston_underlier_rows_pallas(key, contract, **kw)
    # interpret mode: zero-bit RNG -> pure-drift skeleton, identical paths
    with zero_bits():
        t = np.asarray(
            simulate_heston_underlier_rows_pallas(key, contract, interpret=True, **kw)
        )
    assert t.shape == (8, 128)
    assert np.all(np.isfinite(t)) and np.all(t > 0)
    assert np.allclose(t, t[0, 0])
