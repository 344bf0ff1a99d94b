"""The Heston characteristic function and COS pricing."""
