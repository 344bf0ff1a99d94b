"""Pricers: Black-Scholes, European MC, American LSM and the host oracles."""
