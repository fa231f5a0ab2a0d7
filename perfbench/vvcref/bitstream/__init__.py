"""Bitstream layer: bit IO, NAL / Annex-B packaging, parameter-set and
header syntax (VPS/SPS/PPS/PH/SH) writers and parsers."""
