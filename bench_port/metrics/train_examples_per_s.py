"""Examples of the steps completed in the window over the seconds from the
window's start to the end of its last step (host clock)."""


def read(record):
    if not record.get("steps"):
        return None
    return record["batch"] * record["steps"] / record["to_last_step_s"]
