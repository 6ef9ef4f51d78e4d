"""Model-family dispatch — THE (ModelKind × SimImplementation) seam.

Single source of truth mapping ``SimulationParams`` to the contract model,
the underlier simulator and the analytic-mean target for its dynamics. Every
driver builds from here: the fused train step (``training/step.py``), the
sharded trainer, the Greeks estimators (``ops/greeks.py``), the graft entry
point and the benchmarks. Lives in ``ops`` because selecting a numeric
engine is a numeric-layer concern (the trainer layer composes on top).
"""

from __future__ import annotations

from typing import Callable

import jax

from spectralmc_tpu.ops.gbm import (
    AMERICAN_PAYOFFS,
    CONTRACT_DIM,
    BlackScholesContract,
    ModelKind,
    PayoffKind,
    SamplingKind,
    SimImplementation,
    SimulationParams,
    expected_underlier_mean,
    resolve_implementation,
    simulate_underlier_rows,
)


def contract_class(sim: SimulationParams) -> type:
    """The contract model for the sim's dynamics (the model-family seam)."""
    if sim.model == ModelKind.HESTON:
        from spectralmc_tpu.ops.heston import HestonContract

        return HestonContract
    if sim.model == ModelKind.MERTON_JUMP:
        from spectralmc_tpu.ops.merton import MertonContract

        return MertonContract
    return BlackScholesContract


def contract_dim(sim: SimulationParams) -> int:
    if sim.model == ModelKind.HESTON:
        from spectralmc_tpu.ops.heston import HESTON_CONTRACT_DIM

        return HESTON_CONTRACT_DIM
    if sim.model == ModelKind.MERTON_JUMP:
        from spectralmc_tpu.ops.merton import MERTON_CONTRACT_DIM

        return MERTON_CONTRACT_DIM
    return CONTRACT_DIM


def make_underlier_simulator(
    sim: SimulationParams, *, rows: int, axis_name: str | None = None
) -> Callable[[jax.Array, jax.Array, jax.Array | int], jax.Array]:
    """(key, contract, row_offset) -> [rows, network_size] underliers.

    Selection: (PayoffKind family x ModelKind x SimImplementation); every
    simulator shares the (contract_key, global row, timestep[, component])
    key discipline, so row_offset shard-stability holds regardless of the
    branch taken. ``axis_name`` is the mesh ``paths`` axis when the caller
    runs this simulator under ``shard_map`` — only the AMERICAN kinds use it
    (their cross-path LSMC regression ``psum``s its moment sums so every
    shard applies the identical exercise policy); the pathwise-independent
    simulators ignore it.
    """
    dtype = sim.precision.to_jnp()
    # global pairing half-count: a shard passes its rows + row_offset, but the
    # antithetic partner is defined on GLOBAL row indices (gbm._row_streams)
    anti_half = sim.batches_per_mc_run // 2 if sim.antithetic else None
    # Resolve which engine ACTUALLY runs through the single source of truth
    # (gbm.resolve_implementation) rather than trusting callers to have
    # pre-resolved sim.implementation: a direct caller passing PALLAS with a
    # combination the kernels do not take (e.g. a non-GBM cliquet) must route
    # to the XLA simulator, not splat cliquet kwargs into a Pallas wrapper.
    resolved = resolve_implementation(sim, rows=rows)
    if sim.payoff in AMERICAN_PAYOFFS:
        from spectralmc_tpu.ops.greeks import OptionSide

        american_kwargs: dict[str, object] = {}
        # PALLAS sims take the fused monitor-row forward + identical XLA
        # backward induction. Curved term structures run the XLA forward
        # (the monitor kernels take no coefficient tables) — both routes are
        # what `resolved` already encodes.
        curved_term = sim.term is not None and not sim.term.is_flat()
        use_pallas_american = resolved == SimImplementation.PALLAS
        if sim.model == ModelKind.HESTON:
            if use_pallas_american:
                from spectralmc_tpu.ops.gbm_pallas import (
                    simulate_heston_american_underlier_rows_pallas as _sim_american,
                )
            else:
                from spectralmc_tpu.ops.american import (
                    simulate_heston_american_underlier_rows as _sim_american,
                )
        elif sim.model == ModelKind.MERTON_JUMP:
            if use_pallas_american:
                from spectralmc_tpu.ops.gbm_pallas import (
                    simulate_merton_american_underlier_rows_pallas as _sim_american,
                )
            else:
                from spectralmc_tpu.ops.american import (
                    simulate_merton_american_underlier_rows as _sim_american,
                )
        elif sim.model == ModelKind.BASKET_GBM:
            if use_pallas_american:
                from spectralmc_tpu.ops.gbm_pallas import (
                    simulate_basket_american_underlier_rows_pallas as _sim_american,
                )
            else:
                from spectralmc_tpu.ops.american import (
                    simulate_basket_american_underlier_rows as _sim_american,
                )

            assert sim.basket is not None  # enforced by build_simulation_params
            american_kwargs["spec"] = sim.basket
        elif use_pallas_american:
            from spectralmc_tpu.ops.gbm_pallas import (
                simulate_american_underlier_rows_pallas as _sim_american,
            )

        else:
            from spectralmc_tpu.ops.american import (
                simulate_american_underlier_rows as _sim_american,
            )

            if curved_term:
                american_kwargs["term"] = sim.term

        side = (
            OptionSide.PUT if sim.payoff == PayoffKind.AMERICAN_PUT else OptionSide.CALL
        )
        degree = sim.lsmc_basis_degree
        every = sim.lsmc_exercise_every

        def simulate_american(
            key: jax.Array, contract: jax.Array, row_offset: jax.Array | int = 0
        ) -> jax.Array:
            return _sim_american(
                key,
                contract,
                timesteps=sim.timesteps,
                rows=rows,
                cols=sim.network_size,
                dtype=dtype,
                option=side,
                basis_degree=degree,
                exercise_every=every,
                row_offset=row_offset,
                antithetic_half=anti_half,
                axis_name=axis_name,
                cross_fit=sim.lsmc_cross_fit,
                **american_kwargs,
            )

        return simulate_american

    # QMC sampling always routes to the XLA simulators (the bridge matmul is
    # matmul-shaped work), non-GBM cliquets take the XLA scan, and unsupported
    # dtypes/shapes/backends take XLA — all encoded by `resolved` above.
    use_pallas = resolved == SimImplementation.PALLAS
    sampling_kwargs: dict[str, object] = {}
    if sim.sampling != SamplingKind.PSEUDO:
        sampling_kwargs["sampling"] = sim.sampling
        sampling_kwargs["mc_seed"] = sim.mc_seed
    if sim.cliquet_reset_every is not None:
        # the GBM wrappers (both engines) take the knobs: the XLA scan
        # threads the reset grid and the Pallas wrapper routes flat
        # log-Euler cliquets to the per-period kernel (falling back itself
        # in lockstep with ops/gbm.py::resolve_implementation). The other
        # dynamics' Pallas wrappers take none — cliquets resolve to XLA
        # there, so use_pallas is False whenever a trainer built the sim.
        sampling_kwargs["cliquet_reset_every"] = sim.cliquet_reset_every
        sampling_kwargs["cliquet_floor"] = sim.cliquet_floor
        sampling_kwargs["cliquet_cap"] = sim.cliquet_cap
    family_kwargs = dict(sampling_kwargs)
    if sim.term is not None and sim.model != ModelKind.GBM:
        # round 4: Heston (rate/div) and Merton/basket (rate/div/vol) curves
        # run their XLA scans — resolve_implementation routes curved non-GBM
        # sims to XLA, so the Pallas family wrappers never see the knob
        family_kwargs["term"] = sim.term

    if sim.model == ModelKind.BASKET_GBM:
        if use_pallas:
            from spectralmc_tpu.ops.gbm_pallas import (
                simulate_basket_underlier_rows_pallas as _sim_basket,
            )
        else:
            from spectralmc_tpu.ops.basket import (
                simulate_basket_underlier_rows as _sim_basket,
            )

        spec = sim.basket
        assert spec is not None  # enforced by build_simulation_params

        def simulate(
            key: jax.Array, contract: jax.Array, row_offset: jax.Array | int = 0
        ) -> jax.Array:
            return _sim_basket(
                key,
                contract,
                spec=spec,
                timesteps=sim.timesteps,
                rows=rows,
                cols=sim.network_size,
                dtype=dtype,
                payoff=sim.payoff,
                row_offset=row_offset,
                barrier_rel=sim.barrier_rel,
                forward_start_step=sim.forward_start_step,
                antithetic_half=anti_half,
                **family_kwargs,
            )

        return simulate

    if sim.model == ModelKind.MERTON_JUMP:
        if use_pallas:
            from spectralmc_tpu.ops.gbm_pallas import (
                simulate_merton_underlier_rows_pallas as _sim_merton,
            )
        else:
            from spectralmc_tpu.ops.merton import (
                simulate_merton_underlier_rows as _sim_merton,
            )

        def simulate(
            key: jax.Array, contract: jax.Array, row_offset: jax.Array | int = 0
        ) -> jax.Array:
            return _sim_merton(
                key,
                contract,
                timesteps=sim.timesteps,
                rows=rows,
                cols=sim.network_size,
                dtype=dtype,
                payoff=sim.payoff,
                row_offset=row_offset,
                barrier_rel=sim.barrier_rel,
                forward_start_step=sim.forward_start_step,
                antithetic_half=anti_half,
                **family_kwargs,
            )

        return simulate

    if sim.model == ModelKind.HESTON:
        if use_pallas:
            from spectralmc_tpu.ops.gbm_pallas import (
                simulate_heston_underlier_rows_pallas as _sim_heston,
            )
        else:
            from spectralmc_tpu.ops.heston import (
                simulate_heston_underlier_rows as _sim_heston,
            )

        def simulate(
            key: jax.Array, contract: jax.Array, row_offset: jax.Array | int = 0
        ) -> jax.Array:
            return _sim_heston(
                key,
                contract,
                timesteps=sim.timesteps,
                rows=rows,
                cols=sim.network_size,
                dtype=dtype,
                payoff=sim.payoff,
                row_offset=row_offset,
                barrier_rel=sim.barrier_rel,
                forward_start_step=sim.forward_start_step,
                antithetic_half=anti_half,
                **family_kwargs,
            )

        return simulate

    if use_pallas:
        from spectralmc_tpu.ops.gbm_pallas import (
            simulate_underlier_rows_pallas as _sim_gbm,
        )
    else:
        _sim_gbm = simulate_underlier_rows

    gbm_kwargs = sampling_kwargs
    if sim.term is not None:
        # both engines take the knob: the XLA scan threads per-step
        # coefficients; the Pallas wrapper routes curved terms to the term
        # kernel (flat terms to the flat kernel) and falls back itself
        gbm_kwargs = {**sampling_kwargs, "term": sim.term}

    def simulate(
        key: jax.Array, contract: jax.Array, row_offset: jax.Array | int = 0
    ) -> jax.Array:
        return _sim_gbm(
            key,
            contract,
            timesteps=sim.timesteps,
            rows=rows,
            cols=sim.network_size,
            dtype=dtype,
            scheme=sim.scheme,
            payoff=sim.payoff,
            row_offset=row_offset,
            barrier_rel=sim.barrier_rel,
            forward_start_step=sim.forward_start_step,
            antithetic_half=anti_half,
            **gbm_kwargs,
        )

    return simulate


def make_mean_target(
    sim: SimulationParams,
) -> Callable[[jax.Array], jax.Array | None]:
    """contract -> analytic E[underlier] (None where no closed form exists)."""
    dtype = sim.precision.to_jnp()
    if sim.model == ModelKind.BASKET_GBM:
        from spectralmc_tpu.ops.basket import expected_basket_underlier_mean

        spec = sim.basket
        assert spec is not None

        def basket_mean(contract: jax.Array) -> jax.Array | None:
            return expected_basket_underlier_mean(
                contract, spec, timesteps=sim.timesteps, payoff=sim.payoff, dtype=dtype,
                forward_start_step=sim.forward_start_step,
                cliquet_reset_every=sim.cliquet_reset_every,
                cliquet_floor=sim.cliquet_floor,
                cliquet_cap=sim.cliquet_cap,
                term=sim.term,
            )

        return basket_mean

    if sim.model == ModelKind.HESTON:
        from spectralmc_tpu.ops.heston import heston_expected_underlier_mean as _mean
    elif sim.model == ModelKind.MERTON_JUMP:
        from spectralmc_tpu.ops.merton import merton_expected_underlier_mean as _mean
    else:
        _mean = expected_underlier_mean

    def mean_target(contract: jax.Array) -> jax.Array | None:
        kwargs: dict[str, object] = {}
        if sim.term is not None:
            kwargs["term"] = sim.term
        if sim.forward_start_step is not None:
            kwargs["forward_start_step"] = sim.forward_start_step
        if sim.cliquet_reset_every is not None:
            kwargs["cliquet_reset_every"] = sim.cliquet_reset_every
            kwargs["cliquet_floor"] = sim.cliquet_floor
            kwargs["cliquet_cap"] = sim.cliquet_cap
        return _mean(
            contract, timesteps=sim.timesteps, payoff=sim.payoff, dtype=dtype, **kwargs
        )

    return mean_target


__all__ = [
    "contract_class",
    "contract_dim",
    "make_mean_target",
    "make_underlier_simulator",
]
