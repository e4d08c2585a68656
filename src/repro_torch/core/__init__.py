"""The paper's core (port of ``repro/core``): metadata, rules, SlimAdam, SNR."""
from .labels import ParamMeta, flatten_with_names
from .rules import derive_rules, rules_as_tree, rules_to_dims, second_moment_savings, table3_rules
from .slim_adam import ScaleBySlimAdamState, scale_by_slim_adam, slim_adam
from .snr import SNRTracker, compression_ratio, measure_leaf_snr, measure_tree_snr, snr_along_dims

__all__ = ["ParamMeta", "flatten_with_names", "derive_rules", "rules_as_tree", "rules_to_dims",
           "second_moment_savings", "table3_rules", "ScaleBySlimAdamState", "scale_by_slim_adam",
           "slim_adam", "SNRTracker", "compression_ratio", "measure_leaf_snr", "measure_tree_snr",
           "snr_along_dims"]
