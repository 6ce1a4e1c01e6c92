"""Model zoo: dual-encoder MPNNs for ionic-liquid property prediction."""

from .layers import BondMatrixMessage, GatedUpdate, VFTHead
from .dual_encoder import IonEncoder, DualEncoderTrunk
from .viscosity import ViscosityModel
from .melting_point import MeltingPointModel

__all__ = [
    "BondMatrixMessage",
    "GatedUpdate",
    "VFTHead",
    "IonEncoder",
    "DualEncoderTrunk",
    "ViscosityModel",
    "MeltingPointModel",
]
