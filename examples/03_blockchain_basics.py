"""Example 3 — blockchain store basics: commit, chain, verify, tamper.

Parity: reference examples/blockchain_basic + blockchain_integrity.
Run: JAX_PLATFORMS=cpu python examples/03_blockchain_basics.py
"""

# Make the repo importable when run straight from a checkout
import sys
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# Honor JAX_PLATFORMS even where an accelerator plugin overrides the env var
import os
if os.environ.get("JAX_PLATFORMS"):
    import jax
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import asyncio
import tempfile

from spectralmc_tpu.serialization import compute_sha256
from spectralmc_tpu.storage import (
    AsyncBlockchainModelStore,
    ChainValid,
    FileSystemObjectStore,
    verify_chain_detailed,
)


async def main() -> None:
    with tempfile.TemporaryDirectory() as root:
        store = AsyncBlockchainModelStore(FileSystemObjectStore(root, "demo"))

        for i in range(3):
            payload = f"model-checkpoint-{i}".encode()
            version = (
                await store.commit(payload, compute_sha256(payload), f"release {i}")
            ).expect("commit")
            print(f"committed {version.version_id} semver={version.semantic_version} "
                  f"parent={version.parent_hash[:8] or '(genesis)'}")

        verdict = (await verify_chain_detailed(store)).expect("verify")
        assert isinstance(verdict, ChainValid)
        print(f"chain valid: {verdict.versions} versions")

        # tamper with an artifact -> load fails the checksum
        versions = (await store.list_versions()).expect("list")
        target = versions[1]
        await store.object_store.put(
            f"versions/{target.directory_name}/checkpoint.pb", b"tampered!"
        )
        loaded = await store.load_checkpoint(target)
        print(f"tampered load -> {type(loaded).__name__}: {loaded.error!r}")


asyncio.run(main())
