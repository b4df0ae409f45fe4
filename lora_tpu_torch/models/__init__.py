"""Encoder, modulator, demodulator and decoder of the port."""
