"""Heterogeneous channel-group dispatcher (port of
lora_tpu/parallel/dispatch.py).

A deployment monitors channels with mixed (SF, BW, CR, sync) settings.  One
batched demodulate cannot mix symbol sizes, so channels route on the host
into per-config groups, each demodulated as one bank, and the results map
back to the caller's channel ids: expert-parallel routing, with group =
expert and channel = token.  With a mesh each group's bank is padded to a
multiple of the ranks, every rank demodulates and decodes its rows, and
only the compact results are gathered.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..config import LoRaConfig
from ..models.decoder import decode
from ..models.demodulator import demodulate, required_samples
from ..models.softdec import decode_soft, guard_soft_status
from ..ops import cplx
from ..ops.tables import payload_rows
from .mesh import Mesh, channel_sharding, gather_result, shard_demodulate


@dataclasses.dataclass
class GroupResult:
    """Demod/decode results for one channel (see DemodResult/DecodeResult)."""

    channel: int
    cfg: LoRaConfig
    found: bool
    symbols: np.ndarray
    snr: float
    status: int | None = None
    payload: bytes | None = None


def _host_iq(s) -> np.ndarray:
    """One channel's samples (a tensor or an array-like) as host complex64
    numpy."""
    if isinstance(s, torch.Tensor):
        return s.detach().cpu().to(torch.complex64).numpy()
    return np.asarray(s, np.complex64)


class ChannelDispatcher:
    """Route per-channel sample streams to per-config batched demodulates.

    configs: one LoRaConfig per channel.  Streams may have per-channel
    lengths; each group pads to its own (required_samples, longest stream
    plus the payload gather's slack).

    mesh: an optional parallel.Mesh: each group's bank is then padded to a
    multiple of the mesh's ranks, this rank demodulates its channel_sharding
    rows (padding rows demodulate to found=False and are dropped) and
    decodes them, and the compact fields are gathered; every rank returns
    every channel's result.  Without a mesh the banks go to `device` (the
    card when None)."""

    def __init__(self, configs: Sequence[LoRaConfig], soft: bool = False,
                 mesh: Mesh | None = None, device=None):
        # soft=True decodes every group with the soft-decision path
        # (models/softdec): spectra-mode demod + ML codewords
        self.soft = soft
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else device
        self.configs = list(configs)
        self.groups: dict[LoRaConfig, list[int]] = {}
        for ch, cfg in enumerate(self.configs):
            self.groups.setdefault(cfg, []).append(ch)

    def _bank(self, streams, members, cfg: LoRaConfig) -> np.ndarray:
        """The group's bank on the host, this rank's rows with a mesh."""
        need = required_samples(cfg)
        # zero-pad past the longest stream by the payload gather's row-grid
        # slack, so a frame ending at the stream's last sample still passes
        # demodulate's payload-fit check
        slack = (payload_rows(cfg.N, cfg.mtu) - (cfg.mtu + 1) + 1) * cfg.N
        T = max(need, slack + max(streams[ch].shape[-1] for ch in members))
        rows = list(members)
        if self.mesh is not None:
            rows += [None] * ((-len(rows)) % self.mesh.size)
            rows = rows[channel_sharding(self.mesh, len(rows))]
        bank = np.zeros((len(rows), T), np.complex64)
        for i, ch in enumerate(rows):
            if ch is not None:  # padding rows stay zero: no preamble run
                s = _host_iq(streams[ch])
                bank[i, : s.shape[-1]] = s
        return bank

    def run(self, streams: Sequence, with_decode: bool = True
            ) -> list[GroupResult]:
        """streams: per-channel complex samples (host arrays or tensors).
        Returns one GroupResult per channel, in channel order."""
        if len(streams) != len(self.configs):
            raise ValueError("one stream per configured channel required")
        out: list[GroupResult | None] = [None] * len(self.configs)
        for cfg, members in self.groups.items():
            bank = self._bank(streams, members, cfg)
            if self.mesh is not None:
                dem = shard_demodulate(bank, cfg, self.mesh, spectra=self.soft)
            else:
                dem = demodulate(bank, cfg, spectra=self.soft,
                                 device=self.device)
            dec = hard = None
            if with_decode:
                # decode under the sharding, before any gather: the spectra
                # ([B, mtu, N] float32) never leave the rank
                hard = decode(dem.symbols, cfg)
                dec = decode_soft(dem.fft_mag2, cfg) if self.soft else hard
            dem = dataclasses.replace(dem, fft_mag2=None)
            if self.mesh is not None:
                dem = gather_result(dem, self.mesh)
                if with_decode:
                    hard = gather_result(hard, self.mesh)
                    dec = gather_result(dec, self.mesh) if self.soft else hard
            self._collect(out, cfg, members, dem, dec, hard, with_decode)
        return out  # type: ignore[return-value]

    def _collect(self, out, cfg, members, dem, dec, hard, with_decode):
        host = cplx.host
        # a frame only counts if its payload fits the buffer: the
        # demodulator's fit check (symbols are truncated garbage when
        # data_start was clamped)
        found = host(dem.found) & host(dem.payload_complete)
        counts = host(dem.count)
        symbols = host(dem.symbols)
        snr = host(dem.snr)
        if with_decode:
            if self.soft:
                # false-positive guard: a CRC-less soft OK must be confirmed
                # by the hard-decision decode, else SOFT_UNVERIFIED
                statuses = guard_soft_status(dec, hard)
            else:
                statuses = host(dec.status)
            data, off, length = host(dec.data), host(dec.offset), host(
                dec.length)
        for i, ch in enumerate(members):
            r = GroupResult(channel=ch, cfg=cfg, found=bool(found[i]),
                            symbols=symbols[i, : counts[i]].copy(),
                            snr=float(snr[i]))
            if with_decode and found[i]:
                r.status = int(statuses[i])
                if r.status == 0:
                    o, n = int(off[i]), int(length[i])
                    r.payload = bytes(data[i, o : o + n].tolist())
            out[ch] = r
