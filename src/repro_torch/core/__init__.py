"""Confidential-computing core (port of ``repro.core``).

TrustDomain (confidential.py) composes sealing (encrypted weights, CUDA
unseal kernel), attestation (measurement/quote/key-release), encrypted token
I/O (bounce.py), and the calibrated TEE overhead model (overheads.py).
"""

from repro_torch.core.confidential import TrustDomain
from repro_torch.core.sealing import (
    SealingKey, SealedTensor, IntegrityError,
    seal_tensor, unseal_tensor, seal_tree, unseal_tree, tree_digest,
)
from repro_torch.core.attestation import (
    Quote, HardwareRoot, Verifier, AttestationError, measurement, measure_code,
)
from repro_torch.core.bounce import BounceBuffer
from repro_torch.core.overheads import RooflineTerms, TEEProfile, PROFILES, predict

__all__ = [
    "TrustDomain", "SealingKey", "SealedTensor", "IntegrityError",
    "seal_tensor", "unseal_tensor", "seal_tree", "unseal_tree", "tree_digest",
    "Quote", "HardwareRoot", "Verifier", "AttestationError", "measurement",
    "measure_code", "BounceBuffer", "RooflineTerms", "TEEProfile", "PROFILES",
    "predict",
]
