"""Adversarial attacks (counterpart of ``fiode_tpu/attacks``): PGD, APGD-CE,
APGD-T, FAB-T, Square and the AutoAttack suite that composes them."""
from .apgd import apgd_attack, apgd_ce, apgd_targeted
from .autoattack import STANDARD, AutoAttackSuite
from .fab import fab_targeted
from .pgd import pgd_attack
from .square import square_attack

__all__ = ["AutoAttackSuite", "STANDARD", "apgd_attack", "apgd_ce",
           "apgd_targeted", "fab_targeted", "pgd_attack", "square_attack"]
