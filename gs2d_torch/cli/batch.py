"""What the port's batch CLIs (``render_all``, ``run_all``) share: one CLI
of the port run in this process, its failure turned into an exit code, so
one model or scene that fails does not stop the others."""

from __future__ import annotations

import traceback


def run_cli(cli, argv) -> int:
    """``cli.main(argv)`` → 0, the code of a ``SystemExit`` it raised, or 1
    (with the traceback printed) for any other exception."""
    try:
        cli.main(argv)
    except SystemExit as e:
        return e.code if isinstance(e.code, int) else int(e.code is not None)
    except Exception:  # noqa: BLE001 — a failed model is reported, not fatal
        traceback.print_exc()
        return 1
    return 0
