"""The benchmark's plain reference: the receive chain (`receiver`) and an
RDS group decoder (`rds`).  It imports nothing of the program under test."""

from .rds import decode as decode_rds
from .receiver import PlainReceiver, precision

__all__ = ["PlainReceiver", "precision", "decode_rds"]
