"""Content-addressed, Merkle-linked model versioning ("blockchain" store).

Capability parity with ``/root/reference/src/spectralmc/storage/`` (~3,000
LoC): chain primitives, the atomic CAS commit protocol, retry engine, chain
verification, garbage collection, pinned/tracking inference client, audit
log, and the CLI (``python -m spectralmc_tpu.storage``).

JAX-build design notes: the store is host-side and backend-agnostic — an
async ``ObjectStore`` protocol with a hermetic filesystem implementation
(ETag = content SHA-256, compare-and-swap under a lock) and an S3
implementation gated on aioboto3 (absent in this image; the protocol seam is
identical, matching the reference's protocols.py:1-123 approach of typing the
client surface).
"""

from spectralmc_tpu.storage.chain import (
    ModelVersion,
    bump_semantic_version,
    create_genesis_version,
    create_next_version,
)
from spectralmc_tpu.storage.object_store import FileSystemObjectStore, ObjectStore
from spectralmc_tpu.storage.store import AsyncBlockchainModelStore
from spectralmc_tpu.storage.checkpoint import commit_snapshot, load_snapshot_from_checkpoint
from spectralmc_tpu.storage.inference import InferenceClient, PinnedMode, TrackingMode
from spectralmc_tpu.storage.verification import (
    ChainCorrupted,
    ChainValid,
    find_corruption,
    verify_chain_detailed,
    verify_version_completeness,
)
from spectralmc_tpu.storage.gc import ExecuteGC, GarbageCollector, GCReport, PreviewGC, RetentionPolicy

__all__ = [
    "AsyncBlockchainModelStore",
    "ChainCorrupted",
    "ChainValid",
    "ExecuteGC",
    "FileSystemObjectStore",
    "GCReport",
    "GarbageCollector",
    "InferenceClient",
    "ModelVersion",
    "ObjectStore",
    "PinnedMode",
    "PreviewGC",
    "RetentionPolicy",
    "TrackingMode",
    "bump_semantic_version",
    "commit_snapshot",
    "create_genesis_version",
    "create_next_version",
    "find_corruption",
    "load_snapshot_from_checkpoint",
    "verify_chain_detailed",
    "verify_version_completeness",
]
