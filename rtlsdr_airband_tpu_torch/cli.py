"""CLI / daemon entry point of the PyTorch/CUDA port (reference:
src/rtl_airband.cpp:674-766 getopt flags, :904-943 daemonize, :96-99 signal
handling); counterpart of ``rtlsdr_airband_tpu/cli.py``.

    python -m rtlsdr_airband_tpu_torch -F -e -c rtl_airband.conf

Flags mirror the reference: -f foreground with TUI, -F foreground without
TUI, -e log to stderr, -c config path, -v version, -Q quadri FM
discriminator.  Runs as a daemon (double fork + pidfile) when neither -f
nor -F is given.  ``--device cuda`` (the default) runs every pipeline on the
GPU and fails without one; ``--device cpu`` runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys

from . import __version__
from .logutil import LOG_NOTICE, init_logging, log

DEFAULT_CONF = "/usr/local/etc/rtl_airband.conf"  # reference: rtl_airband.h:57-62


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rtl-airband-gpu", description="PyTorch/CUDA multichannel AM/NFM demodulator, mixer, streamer and recorder")
    p.add_argument("-f", dest="foreground_tui", action="store_true", help="run in foreground with TUI waterfall")
    p.add_argument("-F", dest="foreground", action="store_true", help="run in foreground without TUI")
    p.add_argument("-e", dest="stderr_log", action="store_true", help="log to stderr instead of syslog")
    p.add_argument("-c", dest="config", default=DEFAULT_CONF, help=f"config file path (default {DEFAULT_CONF})")
    p.add_argument("-v", dest="version", action="store_true", help="print version and exit")
    p.add_argument("-Q", dest="fm_quadri", action="store_true", help="use quadri-correlator FM discriminator instead of atan2")
    p.add_argument("-d", dest="debug_file", default=None, metavar="FILE", help="write debug log to FILE (reference: -d)")
    p.add_argument("--pidfile", default=None, help="pidfile path when daemonized")
    p.add_argument("--max-seconds", type=float, default=None, help="exit after N seconds (testing)")
    p.add_argument("--profile", default=None, metavar="DIR", help="capture a torch.profiler trace of the run into DIR (Chrome trace JSON, with the program's spans)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="where the pipelines run (default cuda: the GPU, failing without one)")
    p.add_argument("--check-config", action="store_true", help="parse + validate the config and exit (0 = ok)")
    return p


def daemonize(pidfile: str | None) -> None:
    """Double fork (reference: rtl_airband.cpp:904-943)."""
    if os.fork() > 0:
        os._exit(0)
    os.setsid()
    if os.fork() > 0:
        os._exit(0)
    devnull = os.open(os.devnull, os.O_RDWR)
    for fd in (0, 1, 2):
        os.dup2(devnull, fd)
    if pidfile:
        with open(pidfile, "w") as f:
            f.write(str(os.getpid()))


def write_profile(prof, directory: str) -> str:
    """Write a finished profiler's Chrome trace into ``directory``, with the
    program's spans (``runtime/trace.py``) on a row of their own; returns
    the file's path."""
    from .runtime import trace

    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    trace.append_to_chrome_trace(path)
    return path


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.version:
        print(f"rtlsdr-airband-tpu-torch {__version__} (PyTorch/CUDA port)")
        return 0

    foreground = args.foreground or args.foreground_tui
    init_logging("stderr" if (args.stderr_log or foreground) else "syslog")
    if args.debug_file:
        from .logutil import init_debug

        init_debug(args.debug_file)

    from .runtime.config import ConfigError, load_config

    try:
        cfg = load_config(args.config)
    except (ConfigError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.check_config:
        n_ch = sum(len(d.channels) for d in cfg.devices)
        print(f"{args.config}: OK ({len(cfg.devices)} devices, {n_ch} channels, {len(cfg.mixers)} mixers)")
        return 0

    pidfile = args.pidfile or cfg.pidfile
    wrote_pidfile = bool(pidfile) and not foreground
    if not foreground:
        daemonize(pidfile)

    from .app import App

    app = App(cfg, fm_quadri=args.fm_quadri, tui=args.foreground_tui, device=args.device)

    def on_signal(signum, frame):
        log(LOG_NOTICE, f"got signal {signum}, exiting")
        app.do_exit = True

    for sig in (signal.SIGINT, signal.SIGTERM, signal.SIGQUIT):
        signal.signal(sig, on_signal)

    if args.profile:
        # reference analog: gperftools behind WITH_PROFILING
        # (rtl_airband.cpp:702-703,1160-1162)
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if args.device == "cuda" else [])
        with profile(activities=activities) as prof:
            app.run(max_seconds=args.max_seconds)
        path = write_profile(prof, args.profile)
        log(LOG_NOTICE, f"profile written to {path}")
    else:
        app.run(max_seconds=args.max_seconds)
    # only remove a pidfile this process actually wrote (a foreground run
    # must not delete a concurrently running daemon's pidfile)
    if wrote_pidfile and os.path.exists(pidfile):
        os.unlink(pidfile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
