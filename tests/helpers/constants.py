"""Tolerances and default workload shapes (parity: reference tests/helpers/constants.py).

FP tolerances match the reference exactly (constants.py:40-70); workload
shapes are scaled for the 8-virtual-device CPU backend — the full-size shapes
run on the GPU via chip_smoke.py and bench.py.
"""

RTOL_F32 = 1e-5
ATOL_F32 = 1e-8
RTOL_F64 = 1e-8
ATOL_F64 = 1e-10

# Small statistical-test workload (reference uses 2^15*256 paths on GPU).
STAT_TIMESTEPS = 1
STAT_NETWORK_SIZE = 64
STAT_BATCHES = 256  # total_paths = 16384
STAT_CONTRACTS = 16
STAT_REPS = 8

# E2E workload (parity with reference tests/test_e2e: 16 x 128 x 4).
E2E_TIMESTEPS = 8
E2E_NETWORK_SIZE = 32
E2E_BATCHES = 4
