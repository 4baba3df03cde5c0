from audio_pattern_discovery.cli import main

raise SystemExit(main())
