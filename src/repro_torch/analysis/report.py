"""Result types shared by the analyzer passes (port of
``repro/analysis/report.py``).

A pass runs a batch of named checks and returns a :class:`PassResult`; each
violated contract is one :class:`Finding`. Passes never raise for contract
violations: the runner turns an unexpected exception into a finding, so one
broken pass cannot hide the others' output.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Finding:
    """One violated contract."""

    pass_name: str   # kernelcheck | races | shardcheck | tracecheck | lint
    check: str       # stable check id, e.g. "smem", "spill", "RPR001"
    where: str       # kernel/case, CUDA symbol, arch/mesh/leaf, or file:line
    message: str

    def __str__(self) -> str:
        return f"[{self.pass_name}:{self.check}] {self.where}: {self.message}"


@dataclass
class PassResult:
    """Outcome of one analyzer pass."""

    name: str
    checks: int = 0                      # individual contracts evaluated
    findings: List[Finding] = field(default_factory=list)
    seconds: float = 0.0
    detail: Optional[str] = None         # extra context (e.g. golden diff path)

    @property
    def ok(self) -> bool:
        return not self.findings

    def add(self, check: str, where: str, message: str) -> None:
        self.findings.append(Finding(self.name, check, where, message))
