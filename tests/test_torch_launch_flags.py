"""The port CLI's flag-compatibility table against the JAX CLI's.

Every rule of the JAX package's `launch.serve.FLAG_RULES` has a rule of the
same name and message in the port's table, and nothing else is there (the
port serves every flag of that CLI, ``--data-shard`` included); each fires
exactly once on the reference test's minimal violation
(`tests/test_launch_flags.py`), also through the CLI, which exits with its
message.
"""
import argparse

import pytest

from repro.launch.serve import FLAG_RULES as REF_RULES
from repro_torch.launch import serve as cli
from test_launch_flags import VIOLATIONS

#: flags of the JAX CLI that the port does not serve: none are left
UNPORTED = set(getattr(cli, "NOT_PORTED", ()))


def _flags(over):
    return {"--" + key.replace("_", "-") for key in over}


#: the reference's rules whose minimal violation sets only ported flags
PORTED = sorted(name for name, over in VIOLATIONS.items() if not _flags(over) & UNPORTED)


def ns(**over):
    """The port parser's defaults, overridden."""
    base = vars(cli.parse_args([]))
    base.update(over)
    return argparse.Namespace(**base)


def test_port_rules_are_the_reference_rules_on_ported_flags():
    assert UNPORTED == set() and not hasattr(cli, "NOT_PORTED")
    assert PORTED == sorted(["slo-needs-continuous", "precision-vs-int4", "lm-only-knobs",
                             "sampling-needs-continuous", "speculate-vs-precision",
                             "replicas-range", "workers-range", "slo-vs-fleet",
                             "precision-vs-fleet", "workers-vs-replicas",
                             "workers-vs-fault-plan", "workers-vs-precision",
                             "workers-vs-slo", "workers-vs-data-shard"])
    assert PORTED == sorted(rule.name for rule in REF_RULES)
    ours = {rule.name: rule.error for rule in cli.FLAG_RULES}
    assert len(ours) == len(cli.FLAG_RULES), "duplicate rule names"
    assert ours == {rule.name: rule.error for rule in REF_RULES if rule.name in PORTED}


def test_defaults_are_accepted():
    assert cli.check_flags(ns()) == []


@pytest.mark.parametrize("name", PORTED)
def test_each_rule_fires_exactly_once_on_its_violation(name):
    fired = cli.check_flags(ns(**VIOLATIONS[name]))
    assert [rule.name for rule in fired] == [name]


@pytest.mark.parametrize("over", [
    dict(workers=2),
    dict(workers=2, workload="snn"),
    dict(workers=2, int4=True, speculate=3, temperature=0.7, top_p=0.9),
    dict(workers=2, scheduler="sparsity", mixed_trace=True, workload="snn"),
    dict(replicas=3, fault_plan="0=wedge@4,1=nan@6:slot=0"),
    dict(precision="adaptive", scheduler="sparsity", workload="snn"),
    dict(slo_ms=3000.0, scheduler="slo"),
    dict(speculate=4, temperature=0.8, top_p=0.95),
])
def test_known_good_combinations_pass(over):
    assert cli.check_flags(ns(**over)) == []


def _argv(over):
    argv = []
    for key, value in over.items():
        flag = "--" + key.replace("_", "-")
        argv += [flag] if value is True else [flag, str(value)]
    return argv


@pytest.mark.parametrize("name", PORTED)
def test_cli_exits_with_the_rule_message(name):
    error = next(rule.error for rule in cli.FLAG_RULES if rule.name == name)
    with pytest.raises(SystemExit) as exc:
        cli.main(_argv(VIOLATIONS[name]) + ["--device", "cpu"])
    assert exc.value.code == error
