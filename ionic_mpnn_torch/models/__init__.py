"""Model zoo: dual-encoder MPNNs for ionic-liquid property prediction."""

from .layers import BatchNorm, BondMatrixMessage, Dropout, GatedUpdate, VFTHead
from .dual_encoder import IonEncoder, DualEncoderTrunk
from .viscosity import ViscosityModel
from .melting_point import MeltingPointModel
from .transfer import (STAGE2_UNFREEZE_SUBSTRINGS, TransferMPModel, load_trunk_params,
                       transfer_stage_labels)

__all__ = [
    "BondMatrixMessage",
    "GatedUpdate",
    "VFTHead",
    "IonEncoder",
    "DualEncoderTrunk",
    "ViscosityModel",
    "MeltingPointModel",
    "TransferMPModel",
    "BatchNorm",
    "Dropout",
    "load_trunk_params",
    "transfer_stage_labels",
    "STAGE2_UNFREEZE_SUBSTRINGS",
]
