"""Smoke-test the MinKNOW manager connection. Runs only on sequencer hosts
with minknow_api installed.

    python -m bossruns_torch.tools.check_sequencer_connection [host] [port]
"""
import sys


def main() -> int:
    try:
        from minknow_api.manager import Manager  # type: ignore
    except ImportError:
        print("minknow_api not installed; run this on the sequencing host")
        return 1
    host = sys.argv[1] if len(sys.argv) > 1 else "localhost"
    port = int(sys.argv[2]) if len(sys.argv) > 2 else 9502
    manager = Manager(host=host, port=port)
    print(f"connected to MinKNOW {manager.version}")
    for pos in manager.flow_cell_positions():
        print(f"  position: {pos}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
