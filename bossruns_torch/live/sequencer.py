"""Live-mode bridge: MinKNOW connection, fastq discovery, readfish launch.

Port of the reference's sequencer control-plane semantics
(the reference's boss/live.py): discover the run's output directory and the
BOSS region's channel subset (written by readfish as channels.toml), scan for
newly written fastq files, and spawn the modified readfish entry point as a
child process. All of this is host-side control plane; minknow_api (gRPC) is
optional — a ``Sequencer()`` built without a position is the fake test
backend (live.py:32-37), and device == "TEST" short-circuits the readfish
launch (live.py:248-249).
"""
from __future__ import annotations

import logging
import subprocess
import sys
import time
import tomllib
from pathlib import Path

logger = logging.getLogger("boss_tpu")

#: all six variants the reference scans (boss/live.py:226), including the
#: nonstandard .gzip spellings some MinKNOW builds emit
FASTQ_PATTERNS = ("*.fq", "*.fastq", "*.fq.gz", "*.fastq.gz",
                  "*.fastq.gzip", "*.fq.gzip")


class Sequencer:
    """Device wrapper; without a position acts as the fake test backend."""

    def __init__(self, position=None, out_path: str | None = None):
        self.position = position
        self.channels: set[int] = set()
        if position is None:
            self.out_path = out_path or "."
            return
        self.out_path = self._grab_output_dir(position)
        self.device_type = self._grab_device_type(position)

    @staticmethod
    def _grab_output_dir(position, retries: int = 10, wait: int = 10) -> str:
        """Poll MinKNOW for the run's output path (live.py:42-69)."""
        for _ in range(retries):
            try:
                run = position.connect().protocol.get_current_protocol_run()
                if run.output_path:
                    return run.output_path
            except Exception as e:  # noqa: BLE001 - device may not be ready yet
                logger.info(f"waiting for sequencing to begin: {e}")
            time.sleep(wait)
        raise TimeoutError("could not grab output directory from device")

    @staticmethod
    def _grab_device_type(position) -> str:
        try:
            return str(position.device_type)
        except Exception:  # noqa: BLE001
            return "unknown"

    def grab_channels(self, run_name: str, retries: int = 5, wait: int = 30) -> None:
        """Wait for readfish's channels.toml and load this region's channels
        (live.py:96-154). Empty set => single region, use all channels."""
        channels_toml = Path(self.out_path) / "channels.toml"
        for _ in range(retries):
            if channels_toml.exists():
                self.channels = self._parse_channels_toml(channels_toml, run_name)
                return
            logger.info("waiting for channels.toml from readfish")
            time.sleep(wait)
        logger.info("no channels.toml found; using all channels")
        self.channels = set()

    @staticmethod
    def _parse_channels_toml(path: Path, run_name: str) -> set[int]:
        with open(path, "rb") as fh:
            conf = tomllib.load(fh)
        for region in conf.get("conditions", {}).values():
            if isinstance(region, dict) and region.get("name") == run_name:
                return set(region.get("channels", []))
        logger.info(f"region {run_name} not found in channels.toml")
        return set()


class LiveRun:
    """Static helpers around the live loop (live.py:159-268)."""

    MINKNOW_API_MAJOR = 6

    @staticmethod
    def connect_sequencer(device: str, host: str = "localhost", port: int = 9502) -> Sequencer:
        try:
            from minknow_api.manager import Manager  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "minknow_api is not installed; live mode needs a sequencer connection"
            ) from e
        import minknow_api

        major = int(minknow_api.__version__.split(".")[0])
        if major != LiveRun.MINKNOW_API_MAJOR:
            raise RuntimeError(
                f"minknow_api major version {major} unsupported (need {LiveRun.MINKNOW_API_MAJOR})"
            )
        manager = Manager(host=host, port=port)
        for pos in manager.flow_cell_positions():
            if pos.name == device:
                seq = Sequencer(position=pos)
                return seq
        raise ValueError(f"target device {device} not found")

    @staticmethod
    def scan_dir(fastq_pass: str, processed_files: set) -> list[str]:
        """Recursively find new fastq files (live.py:216-234)."""
        found = []
        root = Path(fastq_pass)
        for pattern in FASTQ_PATTERNS:
            found.extend(str(p) for p in root.rglob(pattern))
        return sorted(set(found) - set(processed_files))

    @staticmethod
    def search_running_process(keywords: list[str]) -> int | None:
        """PID of a live process whose cmdline contains all keywords, else
        None (reference boss/utils.py:231-245)."""
        try:
            import psutil
        except ImportError:
            # scan /proc directly — same result without the dependency
            proc = Path("/proc")
            me = str(Path(__file__))
            for pid_dir in proc.iterdir():
                if not pid_dir.name.isdigit():
                    continue
                try:
                    cmd = (pid_dir / "cmdline").read_bytes().replace(b"\0", b" ").decode()
                except OSError:
                    continue
                if cmd and all(k in cmd for k in keywords) and me not in cmd.split()[:1]:
                    return int(pid_dir.name)
            return None
        for p in psutil.process_iter(["pid", "cmdline"]):
            try:
                cmd = " ".join(p.info["cmdline"] or [])
            except (psutil.NoSuchProcess, psutil.AccessDenied):
                continue
            if cmd and all(k in cmd for k in keywords):
                return int(p.info["pid"])
        return None

    @staticmethod
    def launch_readfish(toml: str, device: str, name: str, dry: bool = False) -> subprocess.Popen | None:
        """Spawn the BOSS-modified readfish entry point in the background
        (live.py:238-268). device == 'TEST' short-circuits for tests.

        A readfish_boss already driving this device is left alone (reference
        live.py:252-253): double-launching would corrupt the channels.toml
        handshake and double-issue unblock commands.
        """
        if device == "TEST":
            return None
        existing = LiveRun.search_running_process(["readfish_boss", device])
        if existing is not None:
            logger.info(
                f"readfish_boss already running for {device} (pid {existing}); not launching again"
            )
            return None
        script = Path(__file__).parent / "readfish_boss.py"
        stamp = time.strftime("%Y%m%d-%H%M%S")
        Path("./logs").mkdir(exist_ok=True)
        logfile = open(f"./logs/{stamp}_readfish.log", "w")
        cmd = [sys.executable, str(script), toml, device, name]
        if dry:
            logger.info(f"dry launch: {' '.join(cmd)}")
            logfile.close()
            return None
        logger.info(f"launching readfish: {' '.join(cmd)}")
        return subprocess.Popen(cmd, stdout=logfile, stderr=subprocess.STDOUT)
