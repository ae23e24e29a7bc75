"""Mean tree levels a select walk visits, over every board of every select
call in the traced window."""


def read(record):
    return record.get("select_levels")
