"""Example models ported so far: the DLGM (SVI and local-posterior NUTS)."""
