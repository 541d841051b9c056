"""Command-line configuration shared by the port's entry points.

Every configuration key is a ``--flag``; JSON files named on the command
line apply in order, then the flags override them, as in eve_tpu's
``harness.script_init_common``. ``--device`` picks the torch device
(``cuda`` unless the caller asks for ``cpu``).
"""

import argparse
import json
import logging


def _convert_cli_arg_type(config, key, value):
    config_type = type(getattr(config, key))
    if config_type is bool:
        if value.lower() in ('true', 'yes', 'y') or value == '1':
            return True
        if value.lower() in ('false', 'no', 'n') or value == '0':
            return False
        raise ValueError('Invalid input for bool config "%s": %s'
                         % (key, value))
    if config_type is list:
        return json.loads(value)
    return config_type(value)


def parse_config(argv=None, description='', defaults=None):
    """``(config, args)`` from JSON files and ``--flags``.

    ``defaults`` are set before the files and flags, so both override them.
    """
    from eve_tpu_torch.config import Config

    config = Config()
    config.import_dict(defaults or {})
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument('-v', type=str, default='info',
                        choices=['debug', 'info', 'warning', 'error',
                                 'critical'])
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device to run on (default: cuda)')
    parser.add_argument('config_json', type=str, nargs='*',
                        help='Path(s) to JSON config, parsed in order.')
    for key in Config.keys():
        value = getattr(config, key)
        arg_type = str if isinstance(value, (bool, list)) else type(value)
        parser.add_argument('--' + key.replace('_', '-'), type=arg_type,
                            metavar=str(value),
                            help='Expected type is `%s`.' % type(value).__name__)
    args = parser.parse_args(argv)
    logging.basicConfig(level=args.v.upper(),
                        format='%(asctime)s %(levelname)s %(message)s',
                        datefmt='%d/%m %H:%M:%S')
    logging.getLogger().setLevel(args.v.upper())
    for json_path in args.config_json:
        config.import_json(json_path)
    config.import_dict({
        key: _convert_cli_arg_type(config, key, value)
        for key, value in vars(args).items()
        if value is not None and key not in ('v', 'config_json', 'device')
    })
    return config, args
