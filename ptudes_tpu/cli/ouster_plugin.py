"""Ouster-CLI plugin shim.

The reference registers its command group inside the ``ouster-cli`` tool
by shipping a module in the ``ouster.cli.plugins`` namespace package
(``src/ouster/cli/plugins/ptudes.py:1-4`` + ``setup.py:26``). ouster-cli
also discovers plugins through the ``ouster.cli.plugins`` entry-point
group, which is how this package registers (see ``pyproject.toml``).
ouster-cli is built on click, so this module (and only this module)
imports it: ``ptudes_cli`` is a click command that hands its arguments
to the argparse CLI, :func:`ptudes_tpu.cli.main.main`.
"""
import click

from ptudes_tpu.cli.main import main


@click.command(name="ptudes-tpu", add_help_option=False,
               context_settings={"ignore_unknown_options": True,
                                 "allow_extra_args": True})
@click.argument("args", nargs=-1, type=click.UNPROCESSED)
def ptudes_cli(args):
    """P(oint)(e)tudes: lidar odometry, SLAM and mapping tools."""
    raise SystemExit(main(list(args)))
