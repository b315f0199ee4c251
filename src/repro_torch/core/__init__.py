"""C2MAB-V on torch: confidence bounds, relaxed solve, rounding, bandit."""
