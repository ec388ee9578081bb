"""TOML configuration system, schema-compatible with the reference.

Same sections/keys/defaults as the reference's boss/config.py:24-69 so a
reference user's TOML works unchanged; adds a [tpu] section for device-mesh
options that have no reference counterpart. The template generator and the
readfish-TOML cross-validation (region name must match the experiment name,
config.py:163-183) are preserved; full readfish Conf validation is gated on
readfish being importable.
"""
from __future__ import annotations

import argparse
import logging
import sys
import tomllib
from datetime import datetime
from pathlib import Path

from pydantic import BaseModel, Field, ValidationError

from .utils.misc import init_logger


class GeneralConfig(BaseModel):
    name: str = Field(default="boss", description="Experiment name. Used as output prefix and to match readfish region name")
    ref: str | None = Field(default=None, description="Reference file (fasta or None). Not specifying a file switches operation to AEONS")
    mmi: str | None = Field(default=None, description="Index of reference (will be built if not provided)")
    toml_readfish: str | None = Field(default=None, description="TOML config file for readfish. Not required for simulations.")
    wait: int = Field(default=60, description="Waiting time between updates in live version")
    barcodes: list[str] | None = Field(default=None, description="List of barcodes in the experiment")


class LiveConfig(BaseModel):
    device: str | None = Field(default=None, description="Position on sequencing device")
    host: str = Field(default="localhost", description="Host of sequencing device")
    port: int = Field(default=9502, description="Port of sequencing device")
    data_wait: int = Field(default=100, description="Wait for X Mb of data before first strategy update")


class OptionalConfig(BaseModel):
    reject_refs: str | None = Field(default=None, description="Comma-separated list of headers in reference from which to always reject")
    ploidy: int = Field(default=1, description="Ploidy level")
    lowcov: int = Field(default=10, description="[debug] Minimum coverage")
    temperature: int = Field(default=60, description="[debug] Temperature")
    min_seq_len: int = Field(default=2500, description="[debug] Minimum sequence length")
    min_contig_len: int = Field(default=10_000, description="[debug] Minimum contig length")
    min_s1: int = Field(default=200, description="[debug] Minimum S1")
    min_map_len: int = Field(default=2000, description="[debug] Minimum mapping length")
    tetra: bool = Field(default=True, description="[debug] Switch tetranucleotide frequency tests")
    filter_repeats: bool = Field(default=False, description="[debug] Switch repeat filtering")
    bucket_threshold: int = Field(default=5, description="[debug] At which coverage to switch on the strategy in a bucket")
    resume: bool = Field(default=False, description="Resume from the checkpoint in out_<name>/checkpoint (live + sim)")


class SimulationConfig(BaseModel):
    fq: str | None = Field(default=None, description="Input fastq file")
    batchsize: int = Field(default=4000, description="Number of reads per update")
    maxb: int = Field(default=400, description="Maximum number of batches")
    binit: int = Field(default=5, description="Initial batch size")
    dumptime: int = Field(default=200000000, description="Time (in units of psudo-sequencing time) between writing output fastq files")
    paf_full: str | None = Field(default=None, description="Mappings (PAF) of full-length reads for fast sampling")
    paf_trunc: str | None = Field(default=None, description="Mappings (PAF) of truncated reads for fast sampling")
    accept_unmapped: bool = Field(default=False, description="Accept unmapped reads")


class TpuConfig(BaseModel):
    """TPU-native additions (no reference counterpart)."""

    mesh_genome: int = Field(default=1, description="Device-mesh shards along the genome axis")
    mesh_barcode: int = Field(default=1, description="Device-mesh shards along the barcode axis")
    dtype: str = Field(default="float32", description="Device compute dtype for scores/benefits")
    use_device_aligner: bool = Field(default=True, description="Align with the on-device seed-and-extend kernel instead of precomputed PAFs")


class BossConfig(BaseModel):
    general: GeneralConfig = GeneralConfig()
    live: LiveConfig = LiveConfig()
    optional: OptionalConfig = OptionalConfig()
    simulation: SimulationConfig = SimulationConfig()
    tpu: TpuConfig = TpuConfig()


class Config:
    """Load defaults, overlay a TOML, validate readfish cross-references."""

    def __init__(self, parse: bool = False, toml_path: str | None = None, argv=None):
        self.args = BossConfig()
        if parse or toml_path:
            path = toml_path or self._parse_toml_arg(argv)
            try:
                with Path(path).open("rb") as f:
                    conf = tomllib.load(f)
                self.args = BossConfig.model_validate(conf)
            except ValidationError as e:
                print("Invalid configuration:")
                print(e)
                sys.exit(1)

        if self.args.general.toml_readfish:
            args_readfish = tomllib.loads(
                Path(self.args.general.toml_readfish).read_text(encoding="utf-8")
            )
        else:
            args_readfish = {}

        stamp = datetime.now().strftime("%Y%m%d-%H%M%S")
        Path("./logs").mkdir(parents=True, exist_ok=True)
        self.logfile = f"./logs/{stamp}_boss.log"
        init_logger(self.logfile)
        logging.getLogger("boss_tpu").info(self.args.model_dump())

        # device TEST dry-runs without readfish, so nothing to cross-validate
        if self.args.live.device and self.args.live.device != "TEST":
            self._verify_region_names(self.args, args_readfish)
            self._validate_readfish_conf(args_readfish)

    @staticmethod
    def _parse_toml_arg(argv=None) -> str:
        parser = argparse.ArgumentParser(prog="boss-tpu")
        parser.add_argument("--toml", type=str, required=True, help="TOML configuration file")
        return parser.parse_args(argv).toml

    @staticmethod
    def _verify_region_names(args: BossConfig, args_readfish: dict) -> None:
        """Experiment name must exist as a readfish region (config.py:163-183)."""
        if not isinstance(args_readfish.get("regions"), list):
            raise ValueError("Readfish regions must be specified as array")
        region_names = {r["name"] for r in args_readfish["regions"]}
        if args.general.name not in region_names:
            raise ValueError(
                "One of the regions in readfish needs the same name as the experiment in BOSS"
            )

    @staticmethod
    def _validate_readfish_conf(args_rf: dict) -> int:
        try:
            from readfish._config import Conf  # type: ignore
        except ImportError:
            logging.getLogger("boss_tpu").info(
                "readfish not importable; skipping readfish TOML validation"
            )
            return 0
        try:
            Conf.from_dict(args_rf, 512)
        except Exception:
            raise ValueError("Could not load TOML config for readfish")
        return 0

    @staticmethod
    def write_template(path: Path = Path("config_template.toml")) -> None:
        col = 30
        out = ""
        for section_name, section in BossConfig.model_fields.items():
            out += f"\n[{section_name}]"
            for key, field in section.annotation.model_fields.items():  # type: ignore
                d = field.default
                if d is None:  # TOML has no null: ship unset keys commented out
                    kv = f"# {key} ="
                elif isinstance(d, bool):
                    kv = f"{key} = {str(d).lower()}"
                elif isinstance(d, str):
                    kv = f'{key} = "{d}"'
                else:
                    kv = f"{key} = {d}"
                out += f"\n{kv:<{col}}  # {field.description}"
            out += "\n"
        path.write_text(out)
