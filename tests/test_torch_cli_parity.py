"""The port's command line against the JAX package's
(``experiments/runner.py`` ``build_arg_parser``): for each dataset script,
every JAX action has its counterpart with the same option strings, default,
choices, type, nargs and const, and the port adds ``--device`` alone.
Every flag that JAX's runner takes, the port's runner takes too:
``refuse_unported`` raises only for the combination that JAX's runner
also rejects (``--sampling shuffled_epochs`` off the device-resident
dataset, ``experiments/runner.py:245-249``)."""

import argparse

import pytest

from experiments.runner import build_arg_parser as jax_build_arg_parser
from mmdgan_torch.experiments.runner import build_arg_parser, refuse_unported

# the name each dataset script passes (experiments/{cifar,stl,celeba,lsun}.py)
DATASETS = ["cifar", "stl", "celebA", "lsun"]
KEYS = ("option_strings", "dest", "default", "choices", "type", "nargs", "const")


def _actions(parser: argparse.ArgumentParser) -> dict:
    return {a.dest if not a.option_strings else a.option_strings[0]: a
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def _sample_argvs(action: argparse.Action) -> list:
    """Command lines that pass ``action`` with each value it can take."""
    flag = action.option_strings[0]
    if action.nargs == 0:
        return [[flag]]
    if action.choices:
        return [[flag, str(c)] for c in action.choices]
    value = {int: "2", float: "0.5"}.get(action.type, "1,5" if "imbalanced" in flag else "x")
    return [[flag, value]]


@pytest.mark.parametrize("dataset", DATASETS)
def test_parser_matches_jax_action_by_action(dataset):
    jax_actions = _actions(jax_build_arg_parser(dataset))
    actions = _actions(build_arg_parser(dataset))
    assert set(actions) - set(jax_actions) == {"--device"}
    assert set(jax_actions) <= set(actions)
    for name, want in jax_actions.items():
        got = actions[name]
        assert type(got) is type(want), name
        for key in KEYS:
            assert getattr(got, key) == getattr(want, key), (name, key)
    device = actions["--device"]
    assert device.default == "cuda" and device.type is None


@pytest.mark.parametrize("dataset", DATASETS)
def test_runner_refuses_no_flag_that_jax_takes(dataset):
    """Each JAX flag, alone with every value it can take, passes
    ``refuse_unported``; ``--sampling shuffled_epochs`` needs
    ``--device-dataset`` on both sides."""
    parser = build_arg_parser(dataset)
    jax_parser = jax_build_arg_parser(dataset)
    checked = 0
    for action in _actions(jax_parser).values():
        for argv in _sample_argvs(action):
            jax_args = jax_parser.parse_args(argv)
            args = parser.parse_args(argv)
            assert {k: v for k, v in vars(args).items() if k != "device"} == vars(jax_args)
            if args.sampling != "uniform":
                with pytest.raises(ValueError, match="--device-dataset"):
                    refuse_unported(args)
                args = parser.parse_args(argv + ["--device-dataset"])
            refuse_unported(args)
            checked += 1
    assert checked > len(_actions(jax_parser))   # the choices add command lines
