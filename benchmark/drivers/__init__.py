"""One module a kind of traffic: ``run(ctx)`` builds the system under test,
runs the window and judges what it produced."""
