"""Simulation environment: LLM pool profiles, cost model, partial feedback."""
from repro_torch.env.llm_profiles import Pool, default_rho, paper_pool, zoo_pool

__all__ = ["Pool", "default_rho", "paper_pool", "zoo_pool"]
