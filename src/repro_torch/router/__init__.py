"""Multi-tenant routing: the scheduling cloud's rounding and the fleet."""
