"""Traffic helpers the engine and launcher need (port-local copies of
``repro.serving.traffic.trace`` / ``.metrics`` pieces). Generators,
scenarios, ``MetricsCollector`` and ``SimClock`` come with ROADMAP Queue A
item 9."""
