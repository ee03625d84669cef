"""Proof-carried protocol configuration, validated by the verifier.

TPU-native analog of the reference's config system
(`reference crates/jolt-prover-legacy/src/zkvm/config.rs:95-210`):
the prover CHOOSES a configuration (phase round splits for the read/write
checking sumchecks, one-hot chunking geometry), serializes it in the
proof, and the verifier re-VALIDATES every choice against the public trace
parameters before deriving any expectation from it -- a prover-supplied
config that would break sumcheck soundness (e.g. phase counts exceeding
the variable counts, a chunk size that doesn't tile LOG_K) must be
rejected, never trusted.

Two layers of checks, mirroring the reference split:

  * `validate()` -- the soundness constraints from `zkvm/config.rs`
    (bounds vs log_T / log_K, divisibility of the one-hot chunking).
  * `supported()` -- the subset this prover/verifier pair actually
    implements (the reference gates the same way: log_k_chunk must be 4
    or 8, `OneHotParams::new` asserts).  Our pipeline currently binds all
    cycle rounds then all address rounds (no two-phase streaming split)
    and commits 8-bit ra chunks, so the supported lattice is pinned; the
    fields still travel in the proof so the wire format and the
    validation seam match the reference.
"""

from __future__ import annotations

import dataclasses

from .lookups.tables import LOG_K as LOOKUPS_LOG_K

REGISTERS_LOG_K = 7          # 128 registers (64 arch + 64 virtual)
LOG_K_CHUNK = 8              # committed ra chunk width (OneHotParams)
DORY_LAYOUT = 0              # DoryLayout::default() discriminant
ONEHOT_CHUNK_THRESHOLD_LOG_T = 25   # common/src/constants.rs:1-32


class ConfigError(ValueError):
    """Invalid proof configuration (verifier-side rejection)."""


@dataclasses.dataclass
class ReadWriteConfig:
    """Phase round splits for the RAM / registers read-write checking
    sumchecks (`zkvm/config.rs:95-143`)."""

    ram_rw_phase1_num_rounds: int
    ram_rw_phase2_num_rounds: int
    registers_rw_phase1_num_rounds: int
    registers_rw_phase2_num_rounds: int

    @classmethod
    def new(cls, log_T: int, ram_log_K: int) -> "ReadWriteConfig":
        cfg = cls(ram_rw_phase1_num_rounds=log_T,
                  ram_rw_phase2_num_rounds=ram_log_K,
                  registers_rw_phase1_num_rounds=log_T,
                  registers_rw_phase2_num_rounds=REGISTERS_LOG_K)
        cfg.validate(log_T, ram_log_K)
        return cfg

    def validate(self, log_T: int, ram_log_K: int) -> None:
        if self.ram_rw_phase1_num_rounds > log_T:
            raise ConfigError(
                f"ram_rw_phase1_num_rounds ({self.ram_rw_phase1_num_rounds})"
                f" exceeds log_T ({log_T})")
        if self.ram_rw_phase2_num_rounds > ram_log_K:
            raise ConfigError(
                f"ram_rw_phase2_num_rounds ({self.ram_rw_phase2_num_rounds})"
                f" exceeds ram_log_K ({ram_log_K})")
        if self.registers_rw_phase1_num_rounds > log_T:
            raise ConfigError(
                "registers_rw_phase1_num_rounds "
                f"({self.registers_rw_phase1_num_rounds}) exceeds log_T "
                f"({log_T})")
        if self.registers_rw_phase2_num_rounds > REGISTERS_LOG_K:
            raise ConfigError(
                "registers_rw_phase2_num_rounds "
                f"({self.registers_rw_phase2_num_rounds}) exceeds "
                f"log_register_count ({REGISTERS_LOG_K})")

    def supported(self, log_T: int, ram_log_K: int) -> None:
        """This implementation binds the full cycle hypercube in phase 1
        and the full address hypercube in phase 2."""
        if (self.ram_rw_phase1_num_rounds != log_T
                or self.ram_rw_phase2_num_rounds != ram_log_K
                or self.registers_rw_phase1_num_rounds != log_T
                or self.registers_rw_phase2_num_rounds != REGISTERS_LOG_K):
            raise ConfigError(
                "unsupported read-write phase split (this verifier "
                "implements the full-bind schedule only)")


@dataclasses.dataclass
class OneHotConfig:
    """One-hot chunking geometry (`zkvm/config.rs:146-210`)."""

    log_k_chunk: int
    lookups_ra_virtual_log_k_chunk: int

    @classmethod
    def new(cls, log_T: int) -> "OneHotConfig":
        # reference ladder: small traces use 4-bit chunks; our committed
        # geometry is pinned to 8-bit chunks for every size (the PCS
        # matrix is 256*T rows either way)
        del log_T
        cfg = cls(log_k_chunk=LOG_K_CHUNK,
                  lookups_ra_virtual_log_k_chunk=LOG_K_CHUNK)
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.log_k_chunk not in (4, 8):
            raise ConfigError(
                f"log_k_chunk ({self.log_k_chunk}) must be either 4 or 8")
        lk = self.lookups_ra_virtual_log_k_chunk
        if lk < self.log_k_chunk:
            raise ConfigError(
                f"lookups_ra_virtual_log_k_chunk ({lk}) must be >= "
                f"log_k_chunk ({self.log_k_chunk})")
        if lk > LOOKUPS_LOG_K:
            raise ConfigError(
                f"lookups_ra_virtual_log_k_chunk ({lk}) must be <= "
                f"LOG_K ({LOOKUPS_LOG_K})")
        if lk % self.log_k_chunk:
            raise ConfigError(
                f"lookups_ra_virtual_log_k_chunk ({lk}) must be a "
                f"multiple of log_k_chunk ({self.log_k_chunk})")
        if LOOKUPS_LOG_K % lk:
            raise ConfigError(
                f"lookups_ra_virtual_log_k_chunk ({lk}) must divide "
                f"LOG_K ({LOOKUPS_LOG_K})")

    def supported(self) -> None:
        if self.log_k_chunk != LOG_K_CHUNK:
            raise ConfigError("unsupported log_k_chunk (this build commits "
                              f"{LOG_K_CHUNK}-bit ra chunks)")
        if self.lookups_ra_virtual_log_k_chunk != LOG_K_CHUNK:
            raise ConfigError("unsupported lookups_ra_virtual_log_k_chunk")


@dataclasses.dataclass
class ProofConfig:
    """The full proof-carried configuration: read-write phase splits,
    one-hot geometry, and the Dory layout discriminant.  Travels in the
    proof as a flat string->int dict (schema-stable wire format)."""

    read_write: ReadWriteConfig
    one_hot: OneHotConfig
    dory_layout: int = DORY_LAYOUT
    # committed-bytecode mode (zkvm/prover.rs:2633): 1 = the program
    # image's Val_init contribution is a prover claim reduced to an
    # opening of the committed image polynomial; 0 = the verifier
    # evaluates the public sparse image directly
    committed_program_image: int = 0

    @classmethod
    def new(cls, log_T: int, ram_log_K: int,
            committed_image: bool = False) -> "ProofConfig":
        return cls(read_write=ReadWriteConfig.new(log_T, ram_log_K),
                   one_hot=OneHotConfig.new(log_T),
                   committed_program_image=1 if committed_image else 0)

    def validate(self, log_T: int, ram_log_K: int) -> None:
        """Verifier-side: every constraint from `zkvm/config.rs`, then the
        implementation-support gate.  Raises ConfigError."""
        self.read_write.validate(log_T, ram_log_K)
        self.one_hot.validate()
        if self.dory_layout != DORY_LAYOUT:
            raise ConfigError(f"unknown dory_layout {self.dory_layout}")
        if self.committed_program_image not in (0, 1):
            raise ConfigError("committed_program_image must be 0 or 1")
        self.read_write.supported(log_T, ram_log_K)
        self.one_hot.supported()

    # ---- wire format -----------------------------------------------------

    def as_dict(self) -> dict:
        rw, oh = self.read_write, self.one_hot
        return {
            "ram_rw_phase1_num_rounds": rw.ram_rw_phase1_num_rounds,
            "ram_rw_phase2_num_rounds": rw.ram_rw_phase2_num_rounds,
            "registers_rw_phase1_num_rounds": rw.registers_rw_phase1_num_rounds,
            "registers_rw_phase2_num_rounds": rw.registers_rw_phase2_num_rounds,
            "log_k_chunk": oh.log_k_chunk,
            "lookups_ra_virtual_log_k_chunk": oh.lookups_ra_virtual_log_k_chunk,
            "dory_layout": self.dory_layout,
            "committed_program_image": self.committed_program_image,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ProofConfig":
        try:
            rw = ReadWriteConfig(
                ram_rw_phase1_num_rounds=int(d["ram_rw_phase1_num_rounds"]),
                ram_rw_phase2_num_rounds=int(d["ram_rw_phase2_num_rounds"]),
                registers_rw_phase1_num_rounds=int(
                    d["registers_rw_phase1_num_rounds"]),
                registers_rw_phase2_num_rounds=int(
                    d["registers_rw_phase2_num_rounds"]))
            oh = OneHotConfig(
                log_k_chunk=int(d["log_k_chunk"]),
                lookups_ra_virtual_log_k_chunk=int(
                    d["lookups_ra_virtual_log_k_chunk"]))
            return cls(read_write=rw, one_hot=oh,
                       dory_layout=int(d["dory_layout"]),
                       committed_program_image=int(
                           d.get("committed_program_image", 0)))
        except KeyError as e:
            raise ConfigError(f"proof config missing field {e}") from e
