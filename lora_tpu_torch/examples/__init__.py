"""Twins of lora_tpu's examples (examples/*.py), driving the port.

    python -m lora_tpu_torch.examples.<name> [--device cpu] ...

wideband_rx, lora_simulation, modulation_explained, lora_sdr_relay and
rx_rn2483 keep their counterpart's file name and behaviour.  Each runs on
the card and, without one, raises unless --device names another device;
the two radio examples need SoapySDR, imported only when they run."""
