from .frontend.cli import main

raise SystemExit(main())
