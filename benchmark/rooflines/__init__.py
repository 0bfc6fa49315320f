"""The yardstick's arithmetic: peaks of the card, and the least time a
kernel or a whole step could take on it (``<kernel>.py``)."""
