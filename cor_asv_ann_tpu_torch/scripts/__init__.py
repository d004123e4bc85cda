"""Command-line entry points of the port."""

import click

# one option text for every CLI that runs a model
device_option = click.option(
    '--device', default='cuda',
    help='torch device to run on (cuda, cuda:N or cpu)')
