"""Persistence of compiled plans (``plan_store``)."""
from repro_torch.checkpoint.plan_store import PlanRecord, load_plan, save_plan
