"""Static-verification suite for spectralmc_tpu.

JAX-native counterpart of the reference's ``tools/`` checkers
(``/root/reference/tools/check_purity.py``, ``check_immutability.py``,
``check_pydantic_construction.py``, ``check_type_safety.py``,
``check_code.py`` — SURVEY §2.10): a single AST engine
(:mod:`tools.static_checks.engine`), a file-tier classifier
(:mod:`tools.static_checks.classifier`), and a rule registry
(:mod:`tools.static_checks.rules`) consumed by the thin ``check_*`` CLIs.
"""

from tools.static_checks.classifier import Tier, classify
from tools.static_checks.engine import Violation, run_rules
from tools.static_checks.rules import RULES, rules_in_family

__all__ = ["Tier", "classify", "Violation", "run_rules", "RULES", "rules_in_family"]
