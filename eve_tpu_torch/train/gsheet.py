"""Google Sheets experiment registry logger.

The port's copy of ``eve_tpu/train/gsheet.py``, itself the reference's
``GoogleSheetLogger`` (src/core/gsheet_logger.py:39-206): one row per run
identifier, columns auto-extended from config keys + hostname +
timestamps + LSF job id, update-or-append semantics, an initial row
written at construction (with ``Start Time`` for fresh runs,
src/core/gsheet_logger.py:49-56), and every failure swallowed, so
experiment tracking can never kill a run. ``gspread`` is optional and
imported only when both secrets and a workbook key are set; without it (or
without them) the logger is inert (``ready == False``).
"""

import logging
import os
import socket
import time
import traceback

logger = logging.getLogger(__name__)


class GoogleSheetLogger:

    def __init__(self, config, identifier, resuming=False, enabled=True):
        """``enabled=False`` (every data-parallel rank but 0) writes
        nothing."""
        self.config = config
        self.identifier = identifier
        self.ready = False
        self._sheet = None
        try:
            if not enabled or not config.gsheet_secrets_json_file or \
                    not config.gsheet_workbook_key:
                return
            import gspread  # noqa: F401
            from oauth2client.service_account import ServiceAccountCredentials
            scope = ['https://spreadsheets.google.com/feeds',
                     'https://www.googleapis.com/auth/drive']
            creds = ServiceAccountCredentials.from_json_keyfile_name(
                config.gsheet_secrets_json_file, scope)
            client = gspread.authorize(creds)
            self._workbook = client.open_by_key(config.gsheet_workbook_key)
            self._sheet = self._workbook.sheet1
            self.ready = True
        except Exception:
            logger.warning('GoogleSheetLogger disabled:\n%s',
                           traceback.format_exc())
            self.ready = False
            return
        self._register(resuming)

    def _register(self, resuming):
        """Register the run immediately (reference gsheet_logger.py:49-56):
        fresh runs get a 'Start Time'; resumed runs only refresh info."""
        to_write = {}
        if not resuming:
            to_write['Start Time'] = time.strftime('%Y/%m/%d %H:%M:%S')
        self.update_or_append_row(to_write)

    def fill_in_basic_info(self):
        """Identifier + timestamps + config + host/job metadata
        (reference gsheet_logger.py:62-84: datasrc_*/gsheet_* keys are
        excluded, the hostname column is lowercase, and the LSF job id is
        recorded when running under LSF)."""
        row = {'Identifier': self.identifier,
               'Last Updated': time.strftime('%Y/%m/%d %H:%M:%S')}
        try:
            row.update({k: str(v)
                        for k, v in
                        sorted(self.config.get_all_key_values().items())
                        if not k.startswith('datasrc_')
                        and not k.startswith('gsheet_')})
        except Exception:
            pass
        row['hostname'] = socket.getfqdn()
        if 'LSB_JOBID' in os.environ:
            row['LSF Job ID'] = os.environ['LSB_JOBID']
        return row

    def update_or_append_row(self, values):
        """Write metrics; never raises (reference gsheet_logger.py:54-59)."""
        if not self.ready:
            return
        try:
            row = self.fill_in_basic_info()
            row.update({k: (float(v) if hasattr(v, '__float__') else str(v))
                        for k, v in values.items()})
            header = self._sheet.row_values(1)
            new_cols = [k for k in row if k not in header]
            if new_cols:
                header = header + new_cols
                self._sheet.update('1:1', [header])
            ids = self._sheet.col_values(header.index('Identifier') + 1)
            try:
                row_idx = ids.index(self.identifier) + 1
            except ValueError:
                row_idx = len(ids) + 1
            out = [row.get(col, '') for col in header]
            self._sheet.update('%d:%d' % (row_idx, row_idx), [out])
        except Exception:
            logger.warning('GoogleSheetLogger write failed:\n%s',
                           traceback.format_exc())
