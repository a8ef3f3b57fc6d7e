"""Inference backends: SVI and MCMC (NUTS, HMC)."""
