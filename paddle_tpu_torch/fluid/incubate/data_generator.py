"""``fluid.incubate.data_generator`` (ref: incubate/data_generator/
__init__.py): the MultiSlot generators of ``data.data_generator``."""

from ...data.data_generator import (DataGenerator,  # noqa: F401
                                    MultiSlotDataGenerator,
                                    MultiSlotStringDataGenerator)
