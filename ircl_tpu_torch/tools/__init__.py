"""One-off measurement scripts of the port, run on the card by hand."""
