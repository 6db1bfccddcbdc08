"""Logical-axis sharding rules: the port of ``repro/sharding``."""
from repro_torch.sharding.rules import (DEFAULT_RULES, FSDP_RULES,
                                        NamedSharding, ShardingRules,
                                        choose_spec, placements, spec_tree)

__all__ = ["DEFAULT_RULES", "FSDP_RULES", "NamedSharding", "ShardingRules",
           "choose_spec", "placements", "spec_tree"]
