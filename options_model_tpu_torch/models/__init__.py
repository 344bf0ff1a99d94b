"""Path simulators: GBM, Heston (full-truncation Euler, QE-M) and local vol."""
