"""Configuration schema + loader.

Consumes RTLSDR-Airband-style config files (same libconfig surface syntax and
option vocabulary — reference: config.cpp:306-884, rtl_airband.cpp:780-827)
and maps them onto the pipeline's dataclasses (the JAX package's schema,
unchanged, so one file configures either package).  Hardware-only options
(gain, correction, device index/serial) are parsed and retained but unused by
the file/stream ingest frontend.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..constants import DEFAULT_SAMPLE_RATE
from ..ops.params import ChannelSpec
from . import libconfig


class ConfigError(ValueError):
    pass


# demod_backend as a config file says it -> the port's PipelineConfig
# demod_backend.  The JAX package's values are accepted so that one file runs
# in both packages: its Pallas kernel (and 'auto', which picks it) becomes the
# CUDA kernel K1, its XLA scan the plain PyTorch version.
PIPELINE_BACKENDS = {"auto": "cuda", "pallas": "cuda", "cuda": "cuda", "xla": "plain", "plain": "plain"}


def pipeline_backend(value: str) -> str:
    """The port's ``PipelineConfig.demod_backend`` for a config value."""
    try:
        return PIPELINE_BACKENDS[value]
    except KeyError:
        raise ConfigError(f"demod_backend {value!r} (auto|pallas|cuda|xla|plain)") from None


def parse_anynum_hz(v: Any) -> int:
    """int = Hz, float = MHz, string = suffixed (reference: config.cpp:292-304,
    util.cpp:129-155 atofs)."""
    if isinstance(v, bool):
        raise ConfigError(f"invalid frequency value {v!r}")
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        return int(v * 1e6)
    if isinstance(v, str):
        s = v.strip()
        mult = 1.0
        if s and s[-1] in "gGmMkK":
            mult = {"g": 1e9, "m": 1e6, "k": 1e3}[s[-1].lower()]
            s = s[:-1]
        return int(float(s) * mult)
    raise ConfigError(f"invalid frequency value {v!r}")


def _per_freq(value: Any, n: int, caster, what: str) -> list:
    """Scalar-or-list polymorphism for per-frequency options
    (reference: config.cpp:443-520 et al.)."""
    if isinstance(value, list):
        if len(value) < n:
            raise ConfigError(f"{what}: list needs at least {n} elements")
        return [caster(v) for v in value[:n]]
    return [caster(value)] * n


@dataclass
class OutputConfig:
    type: str  # icecast | file | rawfile | mixer | udp_stream | pulse
    # icecast
    server: str = ""
    port: int = 8000
    mountpoint: str = ""
    username: str = "source"
    password: str = ""
    name: str = ""
    genre: str = ""
    description: str = ""
    send_scan_freq_tags: bool = False
    tls: str = "disabled"
    # file / rawfile
    directory: str = ""
    filename_template: str = ""
    continuous: bool = False
    append: bool = True
    split_on_transmission: bool = False
    include_freq: bool = False
    dated_subdirectories: bool = False
    # mixer
    balance: float = 0.0
    ampfactor: float = 1.0
    # udp_stream
    dest_address: str = ""
    dest_port: int = 0
    # pulse
    sink: str = ""
    stream_name: str = ""
    enabled: bool = True


@dataclass
class FreqSpec:
    frequency: int
    label: str | None = None
    modulation: str = "am"
    squelch_threshold_dbfs: float | None = None
    squelch_snr_threshold_db: float | None = None
    notch: float = 0.0
    notch_q: float = 10.0
    ctcss: float = 0.0
    bandwidth: float = 0.0
    ampfactor: float = 1.0


@dataclass
class ChannelConfig:
    freqs: list[FreqSpec]
    outputs: list[OutputConfig]
    highpass: int = 100  # MP3 shaping (reference: config.cpp:322-323)
    lowpass: int = 2500
    tau_us: float | None = None
    afc: int = 0

    @property
    def has_iq_outputs(self) -> bool:
        return any(o.type == "rawfile" for o in self.outputs if o.enabled)

    def spec_for(self, freq_idx: int) -> ChannelSpec:
        f = self.freqs[freq_idx]
        return ChannelSpec(
            frequency=f.frequency,
            modulation=f.modulation,
            label=f.label,
            ampfactor=f.ampfactor,
            bandwidth=f.bandwidth,
            notch=f.notch,
            notch_q=f.notch_q,
            ctcss=f.ctcss,
            squelch_threshold_dbfs=f.squelch_threshold_dbfs,
            squelch_snr_threshold_db=f.squelch_snr_threshold_db,
            has_iq_outputs=self.has_iq_outputs,
            tau_us=self.tau_us,
            afc=self.afc,
        )


@dataclass
class DeviceConfig:
    type: str = "file"
    mode: str = "multichannel"  # multichannel | scan
    sample_rate: int = DEFAULT_SAMPLE_RATE
    centerfreq: int = 0
    channels: list[ChannelConfig] = field(default_factory=list)
    # hardware options (passed through to the matching ctypes driver)
    gain: float | None = None
    correction: float = 0.0
    index: int = 0
    serial: str | None = None
    buffers: int = 0  # rtlsdr USB buffer count (input-rtlsdr.cpp:215-221)
    num_buffers: int = 0  # mirisdr libusb buffer count (input-mirisdr.cpp:200-206; default 10)
    device_string: str = ""  # soapysdr device args (input-soapysdr.cpp:151-155)
    antenna: str = ""  # soapysdr antenna selection (input-soapysdr.cpp:187)
    channel: int = 0  # soapysdr RX channel index (input-soapysdr.cpp:184)
    # note: soapysdr hardware AGC is implied by OMITTING gain
    # (input-soapysdr.cpp:157-172); gain may also be a per-element
    # "name1=v1,name2=v2" string for soapysdr
    # file input (reference: input-file.cpp:40-62)
    filepath: str = ""
    speedup_factor: float = 4.0
    sample_format: str = "u8"
    fullscale: float | None = None
    disable: bool = False


@dataclass
class MixerConfig:
    name: str
    outputs: list[OutputConfig]
    # inputs are attached by channels with a mixer output
    highpass: int = 100  # MP3 shaping (reference: config.cpp:856-863)
    lowpass: int = 2500


@dataclass
class GlobalConfig:
    devices: list[DeviceConfig]
    mixers: dict[str, MixerConfig] = field(default_factory=dict)
    fft_size: int = 512
    shout_metadata_delay: int = 3
    localtime: bool = False
    multiple_demod_threads: bool = False
    multiple_output_threads: bool = False
    # Device throughput knob (no reference analog — the reference decouples
    # stages with threads instead, rtl_airband.cpp:1093-1112): how many
    # 125 ms blocks each device chains into one dispatch.  >1 trades
    # control/output latency for fewer dispatches and fetches; scan/AFC
    # devices always dispatch single blocks.
    blocks_per_dispatch: int = 1
    # Fetch knob (no reference analog): >0 caps the device->host audio
    # transfer to this many OPEN channels per block (active-channel gather);
    # closed channels reconstruct as silence.  0 = fetch all channels dense.
    active_fetch_slots: int = 0
    # Fetch knob (no reference analog): ship audio device->host as int16
    # (~90 dB quantization SNR; audio is already clamped to +-1.0) — halves
    # the dominant transfer.  Downstream sinks still see float32.
    fetch_audio_i16: bool = False
    # Fetch knob: audio wire format — '' (use fetch_audio_i16), 'f32',
    # 'i16', or 'i8bf' (per-channel-per-block block-float int8: quarter of
    # f32's bytes at ~49 dB SNR vs the block peak).
    fetch_audio_fmt: str = ""
    # Fetch knob (needs active_fetch_slots): don't ship channels whose
    # block audio is only the deterministic closed-squelch tail (AM 0.94^i
    # fade / 0.5 startup tail) — the host synthesizes it instead.  Frees
    # gather slots and removes the block-0 startup flood.
    suppress_fade_tails: bool = False
    # Fetch knob: ship per-channel stats gauges/counters once per
    # dispatch chunk instead of per block (saves 8 rows x C x 4 B per block;
    # stats/TUI consume them at a 15 s cadence anyway).
    fetch_meta_per_chunk: bool = False
    # Fetch knob: adaptive fetch economy — 'off' or a ladder preset
    # ('auto'): the app pre-warms neighbor (slots, fmt) programs and shifts
    # between them as measured fetch throughput / slot overflow drifts
    # (runtime/economy.py); every shift logs a NOTICE.
    fetch_economy: str = "off"
    # Multi-device mesh (reference analog: multiple_demod_threads device-data
    # parallelism, rtl_airband.cpp:1052-1090): one device's channels span a
    # ('time', 'chan') mesh of the first N distinct GPUs (App raises when
    # fewer are present)
    mesh_devices: int = 0  # 0/1 = single device; N>1 = span N devices
    mesh_time_shards: int = 0  # 0 = auto (2 when devices >= 4 and even)
    demod_backend: str = "auto"  # 'auto' | 'xla' | 'pallas' | 'cuda' | 'plain' (see pipeline_backend)
    log_scan_activity: bool = False
    stats_filepath: str | None = None
    tau_us: float | None = None
    pidfile: str | None = None
    wave_rate: int | None = None  # None = auto (16000 if any NFM, else 8000)

    def resolved_wave_rate(self) -> int:
        if self.wave_rate:
            return self.wave_rate
        any_nfm = any(f.modulation == "nfm" for d in self.devices for ch in d.channels for f in ch.freqs)
        return 16000 if any_nfm else 8000


def _parse_outputs(lst: Any, where: str) -> list[OutputConfig]:
    if not isinstance(lst, list) or not lst:
        raise ConfigError(f"{where}: no outputs defined")
    outs = []
    for i, o in enumerate(lst):
        if o.get("disable", False):
            continue
        typ = o.get("type")
        if typ not in ("icecast", "file", "rawfile", "mixer", "udp_stream", "pulse"):
            raise ConfigError(f"{where}.outputs[{i}]: unknown output type {typ!r}")
        kw = {}
        for k, v in o.items():
            if k in ("type", "disable"):
                continue
            if k == "name" and typ == "mixer":
                kw["name"] = v
            elif k in OutputConfig.__dataclass_fields__:
                kw[k] = v
        out = OutputConfig(type=typ, **kw)
        if typ in ("file", "rawfile"):
            if not out.directory or not out.filename_template:
                raise ConfigError(f"{where}.outputs[{i}]: file output needs directory and filename_template")
            if out.continuous and out.split_on_transmission:
                raise ConfigError(f"{where}.outputs[{i}]: continuous and split_on_transmission are exclusive")
        if typ == "udp_stream" and (not out.dest_address or not out.dest_port):
            raise ConfigError(f"{where}.outputs[{i}]: udp_stream needs dest_address and dest_port")
        if typ == "icecast" and not (out.server and out.mountpoint):
            raise ConfigError(f"{where}.outputs[{i}]: icecast needs server and mountpoint")
        if typ == "icecast" and out.tls not in ("disabled", "auto", "auto_no_plain", "transport", "upgrade"):
            # reference: config.cpp:59-93 errors on unknown tls values
            raise ConfigError(f"{where}.outputs[{i}]: invalid tls mode {out.tls!r}")
        outs.append(out)
    if not outs:
        raise ConfigError(f"{where}: no outputs enabled")
    return outs


def _parse_channel(ch: dict, dev: DeviceConfig, where: str, default_tau: float | None) -> ChannelConfig:
    if "freqs" in ch:
        freq_list = [parse_anynum_hz(f) for f in ch["freqs"]]
    elif "freq" in ch:
        freq_list = [parse_anynum_hz(ch["freq"])]
    else:
        raise ConfigError(f"{where}: channel needs freq or freqs")
    n = len(freq_list)

    labels = ch.get("labels")
    if labels is not None and len(labels) < n:
        raise ConfigError(f"{where}: labels needs at least {n} elements")
    if labels is None and "label" in ch:
        # singular 'label' applies to the (single) frequency
        # (reference: config.cpp:357-358)
        labels = [str(ch["label"])] * n

    if "modulations" in ch:
        mods = _per_freq(ch["modulations"], n, str, f"{where}.modulations")
    else:
        mods = [ch.get("modulation", "am")] * n
    for m in mods:
        if m not in ("am", "nfm"):
            raise ConfigError(f"{where}: unknown modulation {m!r}")

    def opt(key, caster, default):
        if key not in ch:
            return [default] * n
        return _per_freq(ch[key], n, caster, f"{where}.{key}")

    if "squelch" in ch:
        # reference: config.cpp:431-433
        import sys

        print("Warning: 'squelch' no longer supported and will be ignored, use 'squelch_threshold' or 'squelch_snr_threshold' instead", file=sys.stderr)
    sq_thr = opt("squelch_threshold", float, None)
    sq_snr = opt("squelch_snr_threshold", float, None)
    notch = opt("notch", float, 0.0)
    notch_q = opt("notch_q", float, 10.0)
    ctcss = opt("ctcss", float, 0.0)
    bandwidth = [0.0] * n if "bandwidth" not in ch else [float(parse_anynum_hz(v)) for v in (ch["bandwidth"] if isinstance(ch["bandwidth"], list) else [ch["bandwidth"]] * n)][:n]
    ampf = opt("ampfactor", float, 1.0)

    # validations mirroring config.cpp
    for v in sq_thr:
        if v is not None and v > 0:
            raise ConfigError(f"{where}: squelch_threshold must be <= 0 dBFS")
    for v in sq_snr:
        if v is not None and v < 0 and v != -1.0:
            raise ConfigError(f"{where}: squelch_snr_threshold must be >= 0")
    for v in ampf:
        if v < 0:
            raise ConfigError(f"{where}: ampfactor must not be negative")

    freqs = []
    for i in range(n):
        freqs.append(
            FreqSpec(
                frequency=freq_list[i],
                label=(labels[i] if labels else None),
                modulation=mods[i],
                squelch_threshold_dbfs=(sq_thr[i] if sq_thr[i] is not None and sq_thr[i] != 0 else None),
                squelch_snr_threshold_db=(sq_snr[i] if sq_snr[i] is not None and sq_snr[i] != -1.0 else None),
                notch=(notch[i] if notch[i] and notch[i] > 0 else 0.0),
                notch_q=(notch_q[i] if notch_q[i] and notch_q[i] > 0 else 10.0),
                ctcss=(ctcss[i] if ctcss[i] and ctcss[i] > 0 else 0.0),
                bandwidth=(bandwidth[i] if bandwidth[i] and bandwidth[i] > 0 else 0.0),
                ampfactor=ampf[i],
            )
        )

    highpass = int(ch.get("highpass", 100))
    lowpass = int(ch.get("lowpass", 2500))
    if lowpass > 0 and lowpass < highpass:
        raise ConfigError(f"{where}: lowpass must be >= highpass")

    tau = ch.get("tau", None)
    tau_us = float(tau) if tau is not None else default_tau

    outputs = _parse_outputs(ch.get("outputs"), where)
    return ChannelConfig(freqs=freqs, outputs=outputs, highpass=highpass, lowpass=lowpass, tau_us=tau_us, afc=int(ch.get("afc", 0)))


def _parse_device(d: dict, idx: int, fft_size: int, default_tau: float | None) -> DeviceConfig:
    where = f"devices[{idx}]"
    dev = DeviceConfig(
        type=d.get("type", "rtlsdr"),
        mode=d.get("mode", "multichannel"),
        sample_rate=parse_anynum_hz(d.get("sample_rate", DEFAULT_SAMPLE_RATE)),
        gain=d.get("gain"),
        correction=float(d.get("correction", 0.0)),
        index=int(d.get("index", 0)),
        serial=d.get("serial"),
        buffers=int(d.get("buffers", 0)),
        num_buffers=int(d.get("num_buffers", 0)),
        device_string=str(d.get("device_string", "")),
        antenna=str(d.get("antenna", "")),
        channel=int(d.get("channel", 0)),
        filepath=d.get("filepath", ""),
        speedup_factor=float(d.get("speedup_factor", 4.0)),
        sample_format=d.get("sample_format", "u8"),
        fullscale=d.get("fullscale"),
        disable=bool(d.get("disable", False)),
    )
    if dev.mode not in ("multichannel", "scan"):
        raise ConfigError(f"{where}: invalid mode {dev.mode!r}")
    if dev.type == "file" and not dev.filepath:
        raise ConfigError(f"{where}: file input needs 'filepath'")
    if dev.type == "soapysdr" and not dev.device_string:
        # reference: mandatory parameter (input-soapysdr.cpp:151-155)
        raise ConfigError(f"{where}: soapysdr input needs 'device_string'")
    if "num_buffers" in d and dev.num_buffers < 1:
        # reference: input-mirisdr.cpp:200-206
        raise ConfigError(f"{where}: num_buffers must be greater than 0")

    chans = d.get("channels")
    if not isinstance(chans, list) or not chans:
        raise ConfigError(f"{where}: no channels")
    dtau = d.get("tau", default_tau)
    for j, ch in enumerate(chans):
        if ch.get("disable", False):
            continue
        dev.channels.append(_parse_channel(ch, dev, f"{where}.channels[{j}]", dtau))
    if not dev.channels:
        raise ConfigError(f"{where}: no enabled channels")
    if dev.mode == "scan" and (len(dev.channels) != 1):
        raise ConfigError(f"{where}: scan mode requires exactly one channel")

    if "centerfreq" in d:
        dev.centerfreq = parse_anynum_hz(d["centerfreq"])
    elif dev.mode == "scan":
        # tune 20 FFT bins above the first frequency to dodge the DC spike
        # (reference: config.cpp:427-429)
        dev.centerfreq = dev.channels[0].freqs[0].frequency + 20 * (dev.sample_rate // fft_size)
    else:
        raise ConfigError(f"{where}: multichannel mode needs centerfreq")

    # soft warning range check (reference: config.cpp:283-290)
    bw_limit = dev.sample_rate / 2.0 * 0.9
    for ch in dev.channels:
        for f in ch.freqs:
            if abs(f.frequency - dev.centerfreq) >= bw_limit and dev.mode == "multichannel":
                import warnings

                warnings.warn(f"{where}: frequency {f.frequency/1e6:.3f} MHz outside 90% of SDR bandwidth")
    return dev


def parse_config(doc: dict) -> GlobalConfig:
    fft_size = int(doc.get("fft_size", 512))
    if fft_size & (fft_size - 1) or not (256 <= fft_size <= 8192):
        raise ConfigError("fft_size must be a power of 2 in 256..8192")
    if str(doc.get("demod_backend", "auto")) not in PIPELINE_BACKENDS:
        raise ConfigError("demod_backend must be auto, xla, pallas, cuda, or plain")

    default_tau = float(doc["tau"]) if "tau" in doc else None

    mixers: dict[str, MixerConfig] = {}
    for name, m in (doc.get("mixers") or {}).items():
        if m.get("disable", False):
            continue
        hp = int(m.get("highpass", 100))
        lp = int(m.get("lowpass", 2500))
        if lp > 0 and lp < hp:
            raise ConfigError(f"mixers.{name}: lowpass must be >= highpass")
        mixers[name] = MixerConfig(name=name, outputs=_parse_outputs(m.get("outputs"), f"mixers.{name}"), highpass=hp, lowpass=lp)

    devices = []
    for i, d in enumerate(doc.get("devices") or []):
        if d.get("disable", False):
            continue
        devices.append(_parse_device(d, i, fft_size, default_tau))
    if not devices:
        raise ConfigError("no devices configured")

    # validate mixer references
    for d in devices:
        for ch in d.channels:
            for o in ch.outputs:
                if o.type == "mixer" and o.name not in mixers:
                    raise ConfigError(f"unknown mixer {o.name!r}")

    if str(doc.get("fetch_audio_fmt", "")) not in ("", "f32", "i16", "i8bf"):
        raise ConfigError(f"invalid fetch_audio_fmt {doc.get('fetch_audio_fmt')!r} (f32|i16|i8bf)")
    if str(doc.get("fetch_economy", "off")) not in ("off", "auto"):
        raise ConfigError(f"invalid fetch_economy {doc.get('fetch_economy')!r} (off|auto)")

    return GlobalConfig(
        devices=devices,
        mixers=mixers,
        fft_size=fft_size,
        shout_metadata_delay=int(doc.get("shout_metadata_delay", 3)),
        localtime=bool(doc.get("localtime", False)),
        multiple_demod_threads=bool(doc.get("multiple_demod_threads", False)),
        multiple_output_threads=bool(doc.get("multiple_output_threads", False)),
        log_scan_activity=bool(doc.get("log_scan_activity", False)),
        blocks_per_dispatch=max(1, int(doc.get("blocks_per_dispatch", 1))),
        active_fetch_slots=max(0, int(doc.get("active_fetch_slots", 0))),
        fetch_audio_i16=bool(doc.get("fetch_audio_i16", False)),
        fetch_audio_fmt=str(doc.get("fetch_audio_fmt", "")),
        suppress_fade_tails=bool(doc.get("suppress_fade_tails", False)),
        fetch_meta_per_chunk=bool(doc.get("fetch_meta_per_chunk", False)),
        fetch_economy=str(doc.get("fetch_economy", "off")),
        mesh_devices=max(0, int(doc.get("mesh_devices", 0))),
        mesh_time_shards=max(0, int(doc.get("mesh_time_shards", 0))),
        demod_backend=str(doc.get("demod_backend", "auto")),
        stats_filepath=doc.get("stats_filepath"),
        tau_us=default_tau,
        pidfile=doc.get("pidfile"),
        wave_rate=int(doc["wave_rate"]) if "wave_rate" in doc else None,
    )


def load_config(path: str) -> GlobalConfig:
    return parse_config(libconfig.load(path))


def loads_config(text: str) -> GlobalConfig:
    return parse_config(libconfig.loads(text))
