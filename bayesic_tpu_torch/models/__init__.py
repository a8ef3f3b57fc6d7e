"""Example models ported so far: the DLGM (SVI half)."""
