"""Microchip RN2483 LoRa radio control (golden hardware transmitter); a copy
of lora_tpu/hw/rn2483.py, which imports no jax.

The reference drives this radio over a serial AT-style protocol as its
known-good TX for receiver bring-up and for reverse-engineering the SX1272
whitening/CRC tables (RN2483.py:8-103,
RN2483Capture.py:24-56).  Same role here: `RN2483.config()` + `transmit()`
produce over-the-air frames that the receiver must decode bit-exactly.

Requires pyserial (imported lazily).
"""

from __future__ import annotations

import time
from typing import Optional


class RN2483:
    """Serial command driver for the RN2483 radio module."""

    BANDWIDTHS = (125, 250, 500)

    def __init__(self, port: str, baud: int = 57600, timeout: float = 2.0):
        try:
            import serial  # pyserial
        except ImportError as e:  # pragma: no cover - hardware optional
            raise RuntimeError(
                "RN2483 control needs pyserial (pip install pyserial)"
            ) from e
        self._ser = serial.Serial(port, baud, timeout=timeout)
        # reset to a known state before configuring, as the reference does
        # on connect (RN2483.py:22); the reply is the firmware banner
        self.reset()

    def reset(self) -> str:
        """`sys reset` and return the firmware banner line."""
        return self.command("sys reset")

    # -- protocol ------------------------------------------------------------
    def command(self, cmd: str) -> str:
        """Send one command line, return the radio's reply line."""
        self._ser.write((cmd.strip() + "\r\n").encode())
        reply = self._ser.readline().decode(errors="replace").strip()
        return reply

    def expect_ok(self, cmd: str) -> None:
        reply = self.command(cmd)
        if reply != "ok":
            raise RuntimeError(f"RN2483 {cmd!r} -> {reply!r}")

    def version(self) -> str:
        return self.command("sys get ver")

    # -- configuration ---------------------------------------------------------
    def config(
        self,
        freq_hz: int = 868_100_000,
        sf: int = 7,
        bw_khz: int = 125,
        cr: str = "4/7",
        power: int = 14,
        crc: bool = True,
        iq_inverted: bool = False,
        sync: Optional[int] = 0x12,
        watchdog_ms: int = 0,
    ) -> None:
        """Configure LoRa mode (mirrors the reference's configLoRa parameter
        set, RN2483.py:24-56)."""
        if not 7 <= sf <= 12:
            raise ValueError("sf must be in 7..12")
        if bw_khz not in self.BANDWIDTHS:
            raise ValueError(f"bw must be one of {self.BANDWIDTHS}")
        if cr not in ("4/5", "4/6", "4/7", "4/8"):
            raise ValueError("cr must be 4/5..4/8")
        self.command("mac pause")  # release the MAC's hold on the radio
        self.expect_ok("radio set mod lora")
        self.expect_ok(f"radio set freq {freq_hz}")
        self.expect_ok(f"radio set pwr {power}")
        self.expect_ok(f"radio set sf sf{sf}")
        self.expect_ok(f"radio set crc {'on' if crc else 'off'}")
        self.expect_ok(f"radio set iqi {'on' if iq_inverted else 'off'}")
        self.expect_ok(f"radio set cr {cr}")
        self.expect_ok(f"radio set wdt {watchdog_ms}")
        if sync is not None:
            self.expect_ok(f"radio set sync {sync:x}")
        self.expect_ok(f"radio set bw {bw_khz}")

    # -- operations --------------------------------------------------------------
    def transmit(self, payload: bytes) -> None:
        """Hex-encode and transmit one frame (RN2483.py:64-67).

        `mac pause` immediately before every transmit, as the reference
        does (RN2483.py:65): the MAC's pause expires (~49 days counter,
        but firmware may also reclaim the radio after idle/rx activity),
        so pausing only in config() would let a long-idle MAC swallow a
        later `radio tx` with "busy"."""
        self.command("mac pause")
        self.expect_ok("radio tx " + payload.hex())
        # radio reports completion asynchronously
        reply = self._ser.readline().decode(errors="replace").strip()
        if reply not in ("radio_tx_ok", ""):
            raise RuntimeError(f"tx completion: {reply!r}")

    def continuous_wave(self, enable: bool) -> None:
        """CW test carrier on/off (RN2483.py:58-62)."""
        self.expect_ok(f"radio cw {'on' if enable else 'off'}")

    def receive_once(self, timeout_s: float = 5.0) -> Optional[bytes]:
        """Single-shot receive; returns payload bytes or None on timeout."""
        self.expect_ok("radio rx 0")
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            line = self._ser.readline().decode(errors="replace").strip()
            if line.startswith("radio_rx"):
                return bytes.fromhex(line.split()[-1])
            if line == "radio_err":
                return None
        return None

    def close(self) -> None:
        self._ser.close()


def main(argv=None) -> int:  # pragma: no cover - hardware CLI
    """CLI mirroring the reference's optparse tool (RN2483.py:71-103)."""
    import argparse

    ap = argparse.ArgumentParser(description="RN2483 control")
    ap.add_argument("--port", required=True)
    ap.add_argument("--freq", type=int, default=868_100_000)
    ap.add_argument("--sf", type=int, default=7)
    ap.add_argument("--bw", type=int, default=125)
    ap.add_argument("--cr", default="4/7")
    ap.add_argument("--sync", type=lambda s: int(s, 0), default=0x12)
    ap.add_argument("--cw", choices=["on", "off"])
    ap.add_argument("--tx", help="hex payload to transmit")
    args = ap.parse_args(argv)

    radio = RN2483(args.port)
    print("version:", radio.version())
    radio.config(args.freq, args.sf, args.bw, args.cr, sync=args.sync)
    if args.cw:
        radio.continuous_wave(args.cw == "on")
    if args.tx:
        radio.transmit(bytes.fromhex(args.tx))
    radio.close()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
