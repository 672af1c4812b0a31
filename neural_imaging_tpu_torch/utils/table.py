"""
A table of named columns: what the port's results and rate-distortion layers
use of a pandas DataFrame, without pandas (which the JAX package's versions
import and the GPU machine lacks).

Each operation gives pandas' values: ``to_csv`` writes the bytes of
``DataFrame.to_csv(index=False)`` and ``read_csv`` types the columns as
``pandas.read_csv`` does; ``to_string`` lays the rows out as
``DataFrame.to_string`` does for numbers, strings and booleans; ``sort_values``
is a stable sort, ``groupby`` drops NaN keys and sorts them, ``mean`` skips
NaN, ``nunique`` counts distinct non-NaN values.

A column's type follows pandas' inference from its values: all booleans →
bool, all integers → int, numbers with NaN → float (an integer is written as
a float), anything else → object (each value as ``str``, NaN as empty).
"""
import csv
import math
import re

import numpy as np


class Table:
    """Rows of named columns. ``table[column]`` is a numpy array; ``table[column]
    = values`` sets or adds a column."""

    def __init__(self, rows=(), columns=None):
        rows = list(rows)
        if columns is None:
            columns = list(dict.fromkeys(c for row in rows for c in row))
        self.columns = list(columns)
        self.rows = [{c: row.get(c, math.nan) for c in self.columns} for row in rows]

    def __len__(self):
        return len(self.rows)

    def __contains__(self, column):
        return column in self.columns

    @property
    def empty(self):
        return not self.rows

    def __getitem__(self, column):
        if column not in self.columns:
            raise KeyError(column)
        return np.array([row[column] for row in self.rows])

    def __setitem__(self, column, values):
        values = list(values)
        if len(values) != len(self.rows):
            raise ValueError(f'{len(values)} values for a table of {len(self.rows)} rows')
        if column not in self.columns:
            self.columns.append(column)
        for row, value in zip(self.rows, values):
            row[column] = value

    def unique(self, column):
        """The column's distinct values in their order of appearance."""
        return list(dict.fromkeys(row[column] for row in self.rows))

    def nunique(self, column):
        """The number of distinct values of the column, NaN not counted."""
        return len({row[column] for row in self.rows if not is_nan(row[column])})

    def where(self, mask):
        return type(self)([row for row, keep in zip(self.rows, mask) if keep], self.columns)

    def dropna(self, subset):
        return type(self)([row for row in self.rows
                           if not any(is_nan(row[c]) for c in subset)], self.columns)

    def sort_values(self, column):
        """The rows in ascending order of the column (stable; NaN last)."""
        keyed = [row for row in self.rows if not is_nan(row[column])]
        nans = [row for row in self.rows if is_nan(row[column])]
        return type(self)(sorted(keyed, key=lambda row: row[column]) + nans, self.columns)

    def groupby(self, column):
        """[(key, Table)] by ascending key, rows with a NaN key dropped (pandas' groupby)."""
        groups = {}
        for row in self.rows:
            if not is_nan(row[column]):
                groups.setdefault(row[column], []).append(row)
        return [(key, type(self)(groups[key], self.columns)) for key in sorted(groups)]

    def mean(self, column):
        """The mean of a numeric column, NaN skipped (NaN when all are)."""
        values = [float(v) for v in self[column] if not is_nan(v)]
        return float(np.mean(values)) if values else math.nan

    def numeric_columns(self):
        """The columns whose type is int or float (``select_dtypes('number')``)."""
        return [c for c in self.columns if _kind([row[c] for row in self.rows]) in ('int', 'float')]

    def to_csv(self, path):
        kinds = [_kind([row[c] for row in self.rows]) for c in self.columns]
        with open(path, 'w', newline='') as f:
            writer = csv.writer(f, lineterminator='\n')
            writer.writerow(self.columns)
            for row in self.rows:
                writer.writerow([_format_csv(row[c], kind)
                                 for c, kind in zip(self.columns, kinds)])

    @classmethod
    def read_csv(cls, path):
        with open(path, newline='') as f:
            reader = csv.reader(f)
            columns = next(reader)
            cells = list(reader)
        values = [_parse_column([r[i] for r in cells]) for i in range(len(columns))]
        return cls([dict(zip(columns, row)) for row in zip(*values)] if cells else (), columns)

    def to_string(self, index=False):
        """The rows as aligned text, as ``DataFrame.to_string(index=index)``
        lays out columns of numbers, strings and booleans (floats at 6
        decimals with the zeros that every value of the column ends in
        trimmed, or in scientific notation; NaN as 'NaN'; a space before the
        names of numeric columns; with ``index`` a row number column and a
        space before every value)."""
        lead = ' ' if index else ''
        columns = []
        for c in self.columns:
            values = [row[c] for row in self.rows]
            numeric = _kind(values) != 'object'          # a numeric header gets a space
            columns.append([(' ' if numeric else '') + str(c)] + _format_text(values, lead))
        if index:
            numbers = [str(i) for i in range(len(self.rows))]
            width = max([len(n) for n in numbers] + [0])
            columns.insert(0, [''.ljust(width)] + [n.ljust(width) for n in numbers])
        widths = [max(len(v) for v in col) for col in columns]
        lines = []
        for i in range(len(self.rows) + 1):
            cells = [col[i].ljust(w) if index and j == 0 else col[i].rjust(w)
                     for j, (col, w) in enumerate(zip(columns, widths))]
            lines.append(' '.join(cells))
        return '\n'.join(lines)


def is_nan(value):
    return isinstance(value, (float, np.floating)) and math.isnan(value)


def _kind(values):
    """pandas' type of a column of these values."""
    if values and all(isinstance(v, (bool, np.bool_)) for v in values):
        return 'bool'
    if all(isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_))
           for v in values):
        return 'int'
    if all(isinstance(v, (int, float, np.integer, np.floating))
           and not isinstance(v, (bool, np.bool_)) for v in values):
        return 'float'
    return 'object'


def _format_csv(value, kind):
    if is_nan(value):
        return ''
    if kind == 'int':
        return str(int(value))
    if kind == 'float':
        return repr(float(value))
    if isinstance(value, (float, np.floating)):
        return repr(float(value))
    return str(value)


_NUMBER_WITH_DECIMAL = re.compile(r'^\s*[\+-]?[0-9]+\.[0-9]*$')


def _trim_zeros(strings):
    """pandas' ``_trim_zeros_float``: drop the trailing zeros that every
    number with a decimal point ends in, keeping one digit after the point."""
    def trim():
        numbers = [x for x in strings if _NUMBER_WITH_DECIMAL.match(x)]
        return numbers and all(x.endswith('0') for x in numbers)
    while trim():
        strings = [x[:-1] if _NUMBER_WITH_DECIMAL.match(x) else x for x in strings]
    return [x + '0' if _NUMBER_WITH_DECIMAL.match(x) and x.endswith('.') else x for x in strings]


def _format_text(values, lead):
    kind = _kind(values)
    if kind == 'int':
        return [f'{lead}{int(v)}' for v in values]
    if kind == 'bool':
        return [f'{lead}{bool(v)}' for v in values]
    if kind == 'float':
        finite = np.abs(np.array([float(v) for v in values if not is_nan(v)]))
        fmt = '{:' + (' ' if lead else '') + '.6f}'
        strings = [fmt.format(float(v)) if not is_nan(v) else 'NaN' for v in values]
        too_long = max((len(x) for x in strings), default=0) > 6 + 6
        if bool(((finite < 1e-6) & (finite > 0)).any()) or (too_long and bool((finite > 1e6).any())):
            fmt = '{:' + (' ' if lead else '') + '.6e}'
            strings = [fmt.format(float(v)) if not is_nan(v) else 'NaN' for v in values]
        return _trim_zeros(strings)
    return [f'{lead}{"NaN" if is_nan(v) else v}' for v in values]


def _parse_column(cells):
    """A CSV column's values typed as pandas infers them: all integers → int,
    all numbers or empty → float (empty = NaN), else the strings."""
    try:
        if all(c != '' for c in cells):
            return [int(c) for c in cells]
    except ValueError:
        pass
    try:
        return [math.nan if c == '' else float(c) for c in cells]
    except ValueError:
        return cells
