"""Shared CLI plumbing (reference: utils/scripts_utils.py:20-29)."""
import argparse


def basic_train_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument('--config', type=str, required=True,
                        help='path to session YAML config')
    parser.add_argument('--reset_dir', action='store_true',
                        help='delete logs AND weights for this session')
    parser.add_argument('--reset_logs', action='store_true')
    parser.add_argument('--reset_weights', action='store_true')
    parser.add_argument('--yes', action='store_true',
                        help='skip interactive reset confirmations')
    return parser

